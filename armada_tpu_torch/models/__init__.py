"""Scheduling models: the scheduling round in PyTorch.

`problem` builds the dense problem from host job/node/queue objects (numpy),
`state` moves it to a device, `fair_scheduler` runs the round (the CUDA
kernels on a card, the plain version on the CPU), and `problem` decodes the
result back to ids.  The steady-state path keeps the problem on the device
across cycles instead: `incremental.IncrementalBuilder` turns each cycle's
submits, leases and removals into a `slab.DeltaBundle`, and
`slab.DeviceDeltaCache` scatters it into the resident problem.  Every round
can be verified (`verify`) and, on its cadence, explained (`explain`).
`run_round_on_device` is the serial path: one round for one pool, with the
gang-transaction rollback loop.  `dispatch_pool_rounds` is the
pool-parallel one: every pool's round is dispatched before any is fetched,
and pools whose problems match in shape run as one stacked round.  While
the mesh serving plane is armed (parallel/serving.py) every round runs over
the serving mesh's node shards (kernel K-K on a card) and nothing stacks.

Every path runs under the watchdog's discipline (core/watchdog.py).  The
failover ladder is opt-in: only an armed round (supervisor().arm, as serve
does, or ARMADA_WATCHDOG_S > 0) walks it.  Unarmed (the default outside
serve) the round runs inline and every error propagates, a refused
verification too (after its quarantine strike): nothing answers a round of
the card's on the CPU unless the caller asked for that.  The JAX package
walks the ladder on a refused verification even unarmed; ROADMAP Queue 3
records the difference.  Armed, the device attempt runs under the
deadline, and a timeout, a CUDA error (torch.AcceleratorError), a fault
drill or a refused verification re-runs the SAME round from the host
tables: first on each smaller rung of the serving mesh, then on the CPU
rung (the plain versions on the CPU).  Only those four error classes walk
the ladder: any other error -- a failed kernel build, a wrapper's argument
check, a layout mismatch -- is a code fault and propagates untouched.
While the supervisor is degraded every round runs on the CPU rung.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from armada_tpu_torch.core.watchdog import launch_guard
from armada_tpu_torch.models.fair_scheduler import RoundResult, schedule_round
from armada_tpu_torch.models.problem import (
    HostContext,
    RoundOutcome,
    SchedulingProblem,
    begin_decode,
    build_problem,
    decode_result,
)
from armada_tpu_torch.models.state import problem_from_numpy, result_to_numpy
from armada_tpu_torch.ops.trace import recorder as _trace

_CPU = torch.device("cpu")


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'"
        )
    return device


class _ShadowOnce:
    """Shadow thunks with run-once accounting across a failover: the device
    attempt and the re-run share one cursor, so a thunk that already STARTED
    in an abandoned worker is never re-entered (a torn re-run would apply
    host mutations twice; skipping is safe because shadow work is
    decision-independent -- unshipped rows ride the next bundle).  Each
    index is claimed under the lock; the thunk runs outside it."""

    def __init__(self, thunks):
        from armada_tpu_torch.analysis.tsan import make_lock

        self._thunks = list(thunks)
        self._next = 0
        self._lock = make_lock("models.shadow_once")

    def run_pending(self) -> None:
        while True:
            launch_guard("shadow work")
            with self._lock:
                if self._next >= len(self._thunks):
                    return
                fn = self._thunks[self._next]
                idx = self._next
                self._next += 1
            with _trace().span("shadow_thunk", index=idx):
                fn()


def _ladder_errors() -> tuple:
    """The DELIBERATELY NARROW error classes that walk the failover ladder:
    RoundTimeout (a wedged card, its worker abandoned), torch.AcceleratorError
    (a CUDA error under the round), FaultInjected (a drill) and
    RoundVerificationError (verification refused a silently wrong answer).
    Never a bare RuntimeError: a failed nvcc build, a wrapper's argument
    check or a layout mismatch between Python and a kernel is a code fault,
    and a CPU re-run would hide it (and drop every device cache for
    nothing)."""
    from armada_tpu_torch.core import faults
    from armada_tpu_torch.core.watchdog import RoundTimeout
    from armada_tpu_torch.models.verify import RoundVerificationError

    errs = (RoundTimeout, faults.FaultInjected, RoundVerificationError)
    accel = getattr(torch, "AcceleratorError", None)
    return errs + ((accel,) if accel is not None else ())


_KERNELS_READY = False


def _prepare_kernels(device: torch.device) -> None:
    """Build and load the kernel library, and check every wrapper's layout
    against it, BEFORE the first armed round on a card: nvcc's tens of
    seconds must never run inside a deadline, where they would time the
    round out and answer it quietly on the CPU."""
    global _KERNELS_READY
    if device.type != "cuda" or _KERNELS_READY:
        return
    from armada_tpu_torch.kernels import compact, explain, lanes, slab, verify
    from armada_tpu_torch.kernels.build import library

    library()
    for mod in (compact, explain, lanes, slab, verify):
        mod._library()
    _KERNELS_READY = True


def _kernel_kwargs(problem, ctx, config) -> dict:
    """The round's statics: market pools keep bid ordering and run the
    single-commit body whatever ARMADA_COMMIT_K says (the extension never
    commits in a market round); other pools take prefer_large from the
    config and commit_k from the environment at each call."""
    market = bool(problem.market)
    kw = dict(
        num_levels=len(ctx.ladder) + 2,
        max_slots=ctx.max_slots,
        slot_width=ctx.slot_width,
        prefer_large=bool(config.enable_prefer_large_job_ordering and not market),
    )
    if market:
        kw["commit_k"] = 1
    return kw


def _serving_mesh(device):
    """The mesh rounds on `device` run over (None: mesh serving off, its
    ladder exhausted, or the supervisor degraded -- the CPU rung sits below
    the ladder)."""
    from armada_tpu_torch.core.watchdog import supervisor
    from armada_tpu_torch.parallel.serving import mesh_serving

    ms = mesh_serving()
    if not ms.enabled() or supervisor().degraded:
        return None
    return ms.serving_mesh(device)


def _round_env(problem, ctx, config, explain_enabled, device):
    """The per-round prologue shared by run_round_on_device and the
    pool-parallel dispatchers: the kernel statics -- with the serving mesh
    as `mesh` while one is armed: the round learns of the mesh here,
    explicitly -- and the ONE explain cadence tick this round gets (the
    failover ladder re-enters the round body for the SAME round, and the
    re-run keeps the attribution the first attempt was armed for).  Away
    rounds pass explain_enabled=False and never tick: their outcome.explain
    is discarded, and a tick would shift the host pool's cadence."""
    from armada_tpu_torch.models import explain as _explain

    explain_armed = bool(explain_enabled) and _explain.explain_due(getattr(ctx, "pool", ""))
    kw = _kernel_kwargs(problem, ctx, config)
    mesh = _serving_mesh(device)
    if mesh is not None:
        kw["mesh"] = mesh
    return kw, explain_armed


def _env(problem, ctx, config, shadow_work, explain_enabled, device):
    """_round_env's statics and tick, with the round's run-once shadow
    cursor: (kernel_kwargs, shadow, explain_armed)."""
    kw, explain_armed = _round_env(problem, ctx, config, explain_enabled, device)
    return kw, _ShadowOnce(shadow_work), explain_armed


def _single_kwargs(kernel_kwargs: dict) -> dict:
    return {k: v for k, v in kernel_kwargs.items() if k != "mesh"}


def _build_device_problem(problem, device_problem, device, mesh=None):
    """The round's device problem: the caller's (a value, or a zero-arg
    callable such as DeviceDeltaCache.apply), else a fresh upload -- sharded
    onto the serving mesh when one is armed (from-scratch and away rounds),
    so every round sees the same placement.  Incremental rounds arrive on
    the mesh through MeshDeviceDeltaCache, their node axis aligned to it by
    the builders; a problem that does not divide into the mesh is a build
    bug and raises."""
    launch_guard("device problem")
    dp = device_problem() if callable(device_problem) else device_problem
    if dp is None:
        if mesh is not None:
            from armada_tpu_torch.parallel.mesh import shard_problem

            dp = shard_problem(problem, mesh)
        else:
            dp = problem_from_numpy(problem, device)
    elif mesh is not None:
        from armada_tpu_torch.parallel.mesh import _check_divisible

        _check_divisible(dp, mesh)
    return dp


def _host_only(problem) -> bool:
    """True when no field of `problem` lies on a card: the host tables the
    CPU rung may read (a .cpu() of a tensor on a wedged card never
    returns)."""
    return all(not isinstance(a, torch.Tensor) or a.device.type == "cpu" for a in problem)


def _host_tables(problem, host_problem):
    """The round's host tables: `host_problem` (a problem, or a thunk such
    as DeltaBundle.materialize), else `problem` itself when it is a whole
    SchedulingProblem.  None when there are none, or when they lie on a
    card."""
    hp = host_problem() if callable(host_problem) else host_problem
    if hp is None and isinstance(problem, SchedulingProblem):
        hp = problem
    if hp is None or not _host_only(hp):
        return None
    return hp


def _degraded_problem(problem, device_problem, host_problem):
    """The round's problem while the supervisor is degraded: the caller's
    device problem when it lies on the CPU (a delta cache uploads through
    data_device(), so its apply does), else the host tables uploaded to the
    CPU.  Nothing is read back from a card."""
    launch_guard("device problem")
    dp = device_problem() if callable(device_problem) else device_problem
    if dp is not None and dp.g_req.device.type == "cpu":
        return dp
    hp = _host_tables(problem, host_problem)
    if hp is None:
        raise RuntimeError("a round on the CPU rung needs host tables: pass host_problem or a "
                           "problem of host arrays")
    return problem_from_numpy(hp, _CPU)


def _device_id(device) -> str:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _quarantine_strike(reason: str, device, mesh=None) -> None:
    """One verification strike against the card that produced the refused
    round (scheduler/quarantine.DeviceQuarantine).  A mesh lies on one card
    here, so it strikes that card once (the JAX package strikes each chip
    of its mesh)."""
    from armada_tpu_torch.scheduler.quarantine import device_quarantine

    dev = mesh.device if mesh is not None else device
    device_quarantine().record_strikes([_device_id(dev)], reason)


def _failover_ladder(e, *, problem, ctx, config, kernel_kwargs, shadow, explain_armed,
                     host_problem, deadline, device):
    """The mesh degrade ladder and the CPU rung for a failed round -- shared
    by the solo path and the pool-parallel finishers (a failed pool walks
    the ladder ALONE; the other pools' rounds are untouched, which bounds
    the blast radius to one pool).  A refused verification strikes the
    device quarantine.  Unarmed (`deadline` <= 0) there is no rung: `e`
    propagates after its strike."""
    from armada_tpu_torch.core.watchdog import run_with_deadline, supervisor
    from armada_tpu_torch.models.verify import RoundVerificationError
    from armada_tpu_torch.parallel.serving import mesh_serving

    reason = f"{type(e).__name__}: {e}"
    if isinstance(e, RoundVerificationError):
        _quarantine_strike(reason, device, kernel_kwargs.get("mesh"))
    if deadline <= 0:
        raise e
    mesh_sv, sup = mesh_serving(), supervisor()
    errors = _ladder_errors()
    try:
        hp = _host_tables(problem, host_problem)
    except BaseException:
        # the host-table thunk itself failed mid-failover: still record the
        # device loss, so later cycles do not retry the card at a full
        # deadline each, then let the host error surface
        sup.record_failure(reason)
        raise
    if hp is None:
        sup.record_failure(reason)
        raise e  # no host tables to fail over from
    # The mesh ladder before the CPU rung: re-run the SAME round on a halved
    # mesh from the host tables (the reset hooks just replaced every device
    # cache, so the next cycle's apply is one full upload onto the smaller
    # mesh).  A rung that recovers on the card records no failure.
    while mesh_sv.enabled() and not sup.degraded:
        smaller = mesh_sv.degrade(reason)
        if smaller is None:
            break
        n = int(smaller.devices.size)
        _trace().annotate(mesh_degraded=True, mesh_devices=n)
        fn = lambda m=smaller: _run_round_on_mesh(  # noqa: E731
            hp, ctx, config, kernel_kwargs, m, explain_armed, shadow)
        try:
            with _trace().span("mesh_degrade_rerun", devices=n, reason=reason[:300]):
                out = run_with_deadline(fn, deadline, what=f"mesh round ({n} shards)")
            sup.record_success()
            return out
        except errors as e2:
            reason = f"{type(e2).__name__}: {e2}"
            if isinstance(e2, RoundVerificationError):
                _quarantine_strike(reason, device, smaller)
            continue
    # Tag the CYCLE that paid the failover window, and record the re-run
    # as its own span.
    sup.record_failure(reason)
    _trace().annotate(degraded=True, failover_reason=reason[:300])
    with _trace().span("cpu_failover", reason=reason[:300]):
        # a refused verification ON THIS RUNG propagates: the CPU rung is
        # the trusted floor, and looping would never answer
        return _run_round_cpu_failover(hp, ctx, kernel_kwargs, shadow, explain_armed)


def _run_round_on_mesh(host_problem, ctx, config, kernel_kwargs, mesh, explain_armed=False,
                       shadow=None):
    """Re-run the SAME round over a (smaller) mesh from host tables: the
    rung of the degrade ladder between the full mesh and the CPU rung, one
    full sharded upload."""
    from armada_tpu_torch.parallel.mesh import shard_problem

    kw = dict(kernel_kwargs, mesh=mesh)
    launch_guard("mesh re-run")
    return _round_body(shard_problem(host_problem, mesh), ctx, kw, mesh.device,
                       shadow if shadow is not None else _ShadowOnce(()), explain_armed)


def _run_round_cpu_failover(host_problem, ctx, kernel_kwargs, shadow, explain_armed=False):
    """Re-run the SAME round on the CPU rung from host tables: every kernel
    wrapper takes its plain version on CPU tensors.  The device caches were
    reset by the supervisor's hooks; nothing is read back from the card."""
    dp = problem_from_numpy(host_problem, _CPU)
    return _round_body(dp, ctx, _single_kwargs(kernel_kwargs), _CPU, shadow, explain_armed)


def _attempt(fn, deadline, ladder, what="device round", on_failover=None):
    """One device attempt of a round and the ladder behind it: fn() under
    the deadline (inline when unarmed); a _ladder_errors() error calls
    on_failover() and returns ladder(e); an armed success is recorded."""
    from armada_tpu_torch.core.watchdog import run_with_deadline, supervisor

    try:
        out = run_with_deadline(fn, deadline, what=what)
    except _ladder_errors() as e:
        if on_failover is not None:
            on_failover()
        return ladder(e)
    if deadline > 0:
        supervisor().record_success()
    return out


def run_round_on_device(problem, ctx, config, device="cuda", device_problem=None,
                        shadow_work=(), host_problem=None, explain_enabled=True):
    """(result, outcome): run the round on a built problem and decode it,
    including the gang-transaction rollback loop, round verification (when
    armed, models/verify.py) and the explain pass (on its cadence,
    models/explain.py).

    `problem` is the host problem -- a SchedulingProblem of numpy arrays, or
    any object with its small per-round fields (`market`; the incremental
    path passes DeltaBundle.stats_view()).  `device_problem` supplies the
    problem already on `device`, as a value or as a zero-arg callable
    producing it (DeviceDeltaCache.apply inside the round, so an armed
    deadline covers the upload too); without it the problem is uploaded.
    `shadow_work`: zero-arg callables run once between the dispatch and the
    first blocking fetch (decision-independent work, such as the next
    submits and their slab prefetch); a failover resumes after the last
    one that started.  `host_problem` (a problem or a thunk, e.g.
    DeltaBundle.materialize) is the ground truth the failover ladder
    re-runs from; it defaults to `problem` when that is a whole
    SchedulingProblem.  `explain_enabled=False` (away rounds) leaves the
    explain cadence untouched.

    The caller's `device` is not changed by a failover: the supervisor
    decides per round (core/watchdog.py), and while it is degraded the
    round runs on the CPU rung.  See the module docstring for the ladder."""
    from armada_tpu_torch.core import faults
    from armada_tpu_torch.core.watchdog import data_device, supervisor

    device = _resolve_device(device)
    sup = supervisor()
    kernel_kwargs, shadow, explain_armed = _env(problem, ctx, config, shadow_work,
                                                explain_enabled, device)
    if sup.degraded:
        # the degraded steady state: no deadline (the host cannot hang on
        # itself) and no device drill (the card is out of the loop); a
        # refused verification here propagates -- the CPU rung is the floor
        cpu = data_device(device)
        return _round_body(_degraded_problem(problem, device_problem, host_problem), ctx,
                           _single_kwargs(kernel_kwargs), cpu, shadow, explain_armed)

    deadline = sup.deadline_s()
    mesh = kernel_kwargs.get("mesh")
    if deadline > 0:
        _prepare_kernels(device)
        if mesh is not None:
            _trace().annotate(mesh_devices=int(mesh.devices.size))

    def _device_attempt():
        faults.check("device_round")
        launch_guard("device round")
        return _round_body(_build_device_problem(problem, device_problem, device, mesh),
                           ctx, kernel_kwargs, device, shadow, explain_armed)

    return _attempt(_device_attempt, deadline, lambda e: _failover_ladder(
        e, problem=problem, ctx=ctx, config=config, kernel_kwargs=kernel_kwargs, shadow=shadow,
        explain_armed=explain_armed, host_problem=host_problem, deadline=deadline,
        device=device))


def dispatch_round_on_device(problem, ctx, config, device="cuda", device_problem=None,
                             shadow_work=(), host_problem=None, explain_enabled=True):
    """Phase-split run_round_on_device: dispatch NOW -- the device problem,
    the round, its compaction, the verify and explain enqueues, the shadow
    work -- and return a zero-arg ``finish()`` -> (result, outcome) that
    performs the blocking fetch, the verdict, the decode and the rollback
    loop LATER.  Between the two the caller may dispatch other pools'
    rounds.  Decisions equal run_round_on_device's: the split only reorders
    asynchronous enqueues that never read another round's output.

    Error semantics match run_round_on_device's, scoped to THIS round: a
    failed dispatch walks the failover ladder at once (the returned finish
    hands back the re-run); a failed finish walks it at finish time."""
    device = _resolve_device(device)
    env = _env(problem, ctx, config, shadow_work, explain_enabled, device)
    return _dispatch_one(problem, ctx, config, device_problem, host_problem, env, device)


def _dispatch_one(problem, ctx, config, device_problem, host_problem, env, device,
                  on_dispatch_failover=None):
    """dispatch_round_on_device with a precomputed _round_env (the explain
    tick happened there, once per round).  `on_dispatch_failover` fires
    when the DISPATCH walks the ladder (the fallback count moves before any
    finish runs: the pool-parallel degraded attribution needs the pool)."""
    from armada_tpu_torch.core import faults
    from armada_tpu_torch.core.watchdog import data_device, supervisor

    kernel_kwargs, shadow, explain_armed = env
    sup = supervisor()
    mesh = kernel_kwargs.get("mesh")

    if sup.degraded:
        # the CPU rung: nothing to overlap a dispatch against -- run the
        # whole round now and hand back the answer
        out = _round_body(_degraded_problem(problem, device_problem, host_problem), ctx,
                          _single_kwargs(kernel_kwargs), data_device(device), shadow,
                          explain_armed)
        return lambda: out

    deadline = sup.deadline_s()
    if deadline > 0:
        _prepare_kernels(device)

    def ladder(e):
        return _failover_ladder(
            e, problem=problem, ctx=ctx, config=config, kernel_kwargs=kernel_kwargs,
            shadow=shadow, explain_armed=explain_armed, host_problem=host_problem,
            deadline=deadline, device=device,
        )

    def _dispatch_attempt():
        faults.check("device_round")
        launch_guard("round dispatch")
        handle = _dispatch_body(_build_device_problem(problem, device_problem, device, mesh),
                                ctx, kernel_kwargs, device, shadow, explain_armed)
        return lambda: _attempt(lambda: _finish_body(handle), deadline, ladder,
                                what="round fetch")

    def _dispatch_failover(e):
        out = ladder(e)
        return lambda: out

    return _attempt(_dispatch_attempt, deadline, _dispatch_failover, what="round dispatch",
                    on_failover=on_dispatch_failover)


@dataclasses.dataclass
class PoolRoundSpec:
    """One pool's round inputs for dispatch_pool_rounds -- the arguments its
    run_round_on_device call would take."""

    problem: object  # stats_view / SchedulingProblem (host side)
    ctx: object  # HostContext
    device_problem: object = None  # device buffers, or a thunk producing them
    host_problem: object = None  # the failover ladder's ground truth (thunk ok)
    shadow_work: tuple = ()
    explain_enabled: bool = True


def dispatch_pool_rounds(specs, config, allow_stacking=True, device="cuda"):
    """Dispatch MANY pools' rounds through the device before ANY fetch --
    the pool-parallel cycle's device phase (scheduler/algo.py windows).

    Returns ``(finishes, stacked_launches, stacked_pools,
    dispatch_failed)``: ``finishes[i]()`` -> (result, outcome) for
    specs[i], to be called IN POOL ORDER.  Pools whose device problems
    match in every field's shape and dtype, on one device, with the same
    kernel statics, run as ONE stacked round (schedule_round_stacked, kernel
    K-D, after one stacking launch, K-E) with one stacked compaction (K-F)
    and one stacked verification (K-I stacked): one launch sequence, one
    compact fetch, one verify fetch for the whole group --
    ``stacked_launches`` counts them, ``stacked_pools`` the pools they
    covered.  ``dispatch_failed`` is the set of spec indices whose DISPATCH
    already walked the failover ladder (their finishes return the re-run):
    the caller's per-pool degraded attribution needs it, because the
    fallback count moved before any finish ran.

    Stacking is skipped (pipelined dispatch only) while the supervisor is
    degraded (the CPU rung runs each round inline), while the serving mesh
    is armed (every pool's round runs sharded and alone), and while
    ARMADA_FAULT is set (the round_corrupt drills are solo-shaped).  A pool
    whose stacked dispatch or finish fails walks the SAME per-pool ladder
    as the solo path, from its own host tables: blast radius one pool."""
    from armada_tpu_torch.core import faults
    from armada_tpu_torch.core.watchdog import supervisor
    from armada_tpu_torch.parallel.serving import mesh_serving

    device = _resolve_device(device)
    sup = supervisor()
    envs = [_env(s.problem, s.ctx, config, s.shadow_work, s.explain_enabled, device)
            for s in specs]
    can_stack = (
        allow_stacking
        and len(specs) > 1
        and not sup.degraded
        and not mesh_serving().enabled()
        and not os.environ.get("ARMADA_FAULT")
    )
    finishes: list = [None] * len(specs)
    dispatch_failed: set = set()
    if not can_stack:
        for i, s in enumerate(specs):
            finishes[i] = _dispatch_one(
                s.problem, s.ctx, config, s.device_problem, s.host_problem, envs[i], device,
                on_dispatch_failover=lambda i=i: dispatch_failed.add(i),
            )
        return finishes, 0, 0, dispatch_failed

    deadline = sup.deadline_s()
    if deadline > 0:
        _prepare_kernels(device)

    def _fail(i, e):
        """Pool i's dispatch failed: its finish hands back the ladder's
        re-run (unarmed, the ladder raises)."""
        s = specs[i]
        kk, shadow, explain_armed = envs[i]
        out = _failover_ladder(
            e, problem=s.problem, ctx=s.ctx, config=config, kernel_kwargs=kk, shadow=shadow,
            explain_armed=explain_armed, host_problem=s.host_problem, deadline=deadline,
            device=device,
        )
        finishes[i] = lambda: out
        dispatch_failed.add(i)

    def _fail_group(idxs, e):
        for i in idxs:
            _fail(i, e)

    # Phase 1: every pool's device problem (the O(delta) cache scatters),
    # each under its own deadline and blast radius.
    dps: list = [None] * len(specs)
    for i, s in enumerate(specs):

        def _build(s=s):
            faults.check("device_round")
            launch_guard("pool round dispatch")
            return _build_device_problem(s.problem, s.device_problem, device)

        dps[i] = _attempt(_build, deadline, lambda e, i=i: _fail(i, e),
                          what="pool round dispatch")

    # Phase 2: group by (statics, device, exact field shapes and dtypes);
    # insertion order keeps groups in first-member pool order.  torch.Size
    # and dtype objects hash as they are: no per-cycle string work.
    groups: dict = {}
    for i, dp in enumerate(dps):
        if finishes[i] is not None:
            continue
        key = (
            tuple(sorted(envs[i][0].items())),
            dp.g_req.device,
            tuple((t.shape, t.dtype) for t in dp),
        )
        groups.setdefault(key, []).append(i)

    stacked_launches = 0
    stacked_pools = 0
    for key, idxs in groups.items():
        if len(idxs) == 1:
            i = idxs[0]
            finishes[i] = _dispatch_one(
                specs[i].problem, specs[i].ctx, config, dps[i], specs[i].host_problem, envs[i],
                device, on_dispatch_failover=lambda i=i: dispatch_failed.add(i),
            )
            continue
        group_finishes = _attempt(
            lambda idxs=idxs, key=key: _dispatch_stacked_group(
                idxs, specs, envs, dps, config, device, key, deadline),
            deadline, lambda e, idxs=idxs: _fail_group(idxs, e),
            what="stacked pool dispatch",
        )
        if group_finishes is None:
            continue
        stacked_launches += 1
        stacked_pools += len(idxs)
        for i, fin in zip(idxs, group_finishes):
            finishes[i] = fin
    if stacked_launches:
        _trace().annotate(pools_stacked_launches=stacked_launches)
    return finishes, stacked_launches, stacked_pools, dispatch_failed


# (group key) -> (per-pool device problems, stacked problem).  Steady cycles
# present the SAME device problem objects every cycle (DeviceDeltaCache's
# no-op apply hands back its resident problem), so the stack is reused by
# identity.  Entries hold strong references, which makes the identity test
# safe: a cached tensor cannot be freed and its address reused while the
# entry lives.  The size cap bounds what it pins, and the watchdog's reset
# hooks drop it (buffers on a card that is now suspect).
_STACK_CACHE: dict = {}
_STACK_CACHE_CAP = 8


def reset_stack_cache() -> None:
    """Drop every memoized stack (and the device buffers it pins)."""
    _STACK_CACHE.clear()


def _register_stack_reset() -> None:
    from armada_tpu_torch.core.watchdog import add_reset_hook

    add_reset_hook(reset_stack_cache)


_register_stack_reset()


def _stack_problems(key, dps):
    """Stack P device problems along a new leading lane axis -- ONE launch
    of kernel K-E on a card, torch.stack per field on the CPU -- memoized by
    operand identity so idle steady cycles skip even that."""
    from armada_tpu_torch.kernels.lanes import stack

    dps = tuple(dps)
    hit = _STACK_CACHE.get(key)
    if hit is not None and len(hit[0]) == len(dps) and all(
        a is b for a, b in zip(hit[0], dps)
    ):
        return hit[1]
    launch_guard("stack")
    stacked = stack(dps)
    if len(_STACK_CACHE) >= _STACK_CACHE_CAP:
        _STACK_CACHE.clear()
    _STACK_CACHE[key] = (dps, stacked)
    return stacked


def _dispatch_stacked_group(idxs, specs, envs, dps, config, device, group_key, deadline):
    """ONE stacked launch for a shape-matched pool group: stack the device
    problems (K-E), run the stacked round (K-D), dispatch the stacked
    compaction (K-F) and verification (K-I stacked), and hand back per-pool
    finish callables that share the two fetched buffers.  Lane views of the
    problem and the result are sliced lazily (K-G): only the explain pass,
    a rollback re-run and a cap overflow read them.  A lane whose finish
    fails walks the per-pool ladder from its own host tables."""
    from armada_tpu_torch.models import explain as _explain
    from armada_tpu_torch.models import verify as _verify
    from armada_tpu_torch.models.fair_scheduler import schedule_round_stacked
    from armada_tpu_torch.models.problem import begin_decode_stacked, lane_slice
    from armada_tpu_torch.models.xfer import TRANSFER_STATS

    trace = _trace()
    kk = envs[idxs[0]][0]
    ctxs = [specs[i].ctx for i in idxs]
    stacked = _stack_problems(group_key, [dps[i] for i in idxs])
    launch_guard("stacked round")
    with trace.span("kernel_dispatch", stacked=len(idxs)):
        result = schedule_round_stacked(stacked, **kk)
    verify_armed = _verify.verify_enabled()
    launch_guard("stacked decode")
    with trace.span("decode_dispatch", stacked=len(idxs)):
        fins = begin_decode_stacked(result, ctxs)
    ver_buf = None
    if verify_armed:
        launch_guard("stacked verification")
        with trace.span("verify_dispatch", stacked=len(idxs)):
            ver_buf = _verify.dispatch_verify_stacked(stacked, result, fins[0].dispatched[0],
                                                      ctxs)
    vbox: dict = {}

    def ver_rows() -> np.ndarray:
        if "v" not in vbox:
            arr = ver_buf.cpu().numpy()
            TRANSFER_STATS.count_down(arr.nbytes)
            vbox["v"] = arr
        return vbox["v"]

    out = []
    for j, i in enumerate(idxs):
        s = specs[i]
        ctx = s.ctx
        pool = getattr(ctx, "pool", "")
        kk_i, shadow_i, explain_armed = envs[i]
        fin = fins[j]
        lane_result = lambda j=j: lane_slice(result, j)  # noqa: E731
        ver_check = None
        if ver_buf is not None:

            def ver_check(j=j, ctx=ctx, pool=pool, fin=fin):
                fin.fetch()  # this pool's compact row (one shared transfer)
                with _trace().span("verify_fetch", stacked=True):
                    _verify.verdict_of(ver_rows()[j], ctx, pool=pool)

        exp_dispatched = None
        if explain_armed:
            launch_guard("explain")
            with trace.span("explain_dispatch", pool=pool):
                exp_dispatched = _explain.dispatch_explain(lane_slice(stacked, j),
                                                           lane_result(), ctx)
        handle = _RoundHandle(
            dp=(lambda j=j: lane_slice(stacked, j)), ctx=ctx, kernel_kwargs=kk, device=device,
            result=lane_result, finish=fin, ver_check=ver_check, exp_dispatched=exp_dispatched,
            explain_armed=explain_armed, verify_armed=verify_armed, pool=pool,
        )
        shadow_i.run_pending()  # this pool's shadow work rides the stack

        def finish(handle=handle, s=s, kk_i=kk_i, shadow_i=shadow_i, explain_i=explain_armed):
            def ladder(e):
                return _failover_ladder(
                    e, problem=s.problem, ctx=s.ctx, config=config, kernel_kwargs=kk_i,
                    shadow=shadow_i, explain_armed=explain_i, host_problem=s.host_problem,
                    deadline=deadline, device=device,
                )

            return _attempt(lambda: _finish_body(handle), deadline, ladder,
                            what="stacked round fetch")

        out.append(finish)
    return out


class _RoundHandle:
    """What the dispatch half hands the finish half.  `dp` and `result` may
    be zero-arg callables (a stacked lane, sliced on demand)."""

    __slots__ = ("dp", "ctx", "kernel_kwargs", "device", "result", "finish", "ver_check",
                 "exp_dispatched", "explain_armed", "verify_armed", "pool")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    def device_problem(self):
        if callable(self.dp):
            launch_guard("lane slice")
            self.dp = self.dp()
        return self.dp


def _dispatch_body(device_problem, ctx, kernel_kwargs, device, shadow, explain_armed=False
                   ) -> _RoundHandle:
    """The round's dispatch half: the round, the compaction and the
    verify/explain passes are enqueued on the stream without a host sync,
    then the shadow work runs.  Each launch group first asks the watchdog
    whether its attempt was abandoned (core/watchdog.launch_guard)."""
    from armada_tpu_torch.models import explain as _explain
    from armada_tpu_torch.models import verify as _verify

    trace = _trace()
    pool = getattr(ctx, "pool", "")
    launch_guard("round")
    with trace.span("kernel_dispatch"):
        result = schedule_round(device_problem, device=device, **kernel_kwargs)
    # round_corrupt drill (core/faults): corruption on the device BEFORE the
    # compaction, so the decode and the verification both see it, as with a
    # real silently wrong result
    result = _verify.maybe_corrupt_result(result)
    verify_armed = _verify.verify_enabled()
    launch_guard("decode")
    with trace.span("decode_dispatch"):
        finish = begin_decode(result, ctx)
    # Verification rides behind the compaction; its verdict is checked
    # between the compact fetch and the host decode, so a corrupted round
    # never reaches decode.
    ver_check = None
    if verify_armed:
        launch_guard("verification")
        with trace.span("verify_dispatch"):
            ver_dispatched = _verify.dispatch_verify(device_problem, result, finish.dispatched,
                                                     ctx)
        if ver_dispatched is not None:

            def ver_check():
                finish.fetch()  # blocking compact fetch (stashes the raw bytes)
                with _trace().span("verify_fetch"):
                    _verify.finish_verify(ver_dispatched, ctx, pool=pool)

    exp_dispatched = None
    if explain_armed:
        launch_guard("explain")
        with trace.span("explain_dispatch"):
            exp_dispatched = _explain.dispatch_explain(device_problem, result, ctx)
    with trace.span("shadow"):
        shadow.run_pending()
    return _RoundHandle(
        dp=device_problem, ctx=ctx, kernel_kwargs=kernel_kwargs, device=device, result=result,
        finish=finish, ver_check=ver_check, exp_dispatched=exp_dispatched,
        explain_armed=explain_armed, verify_armed=verify_armed, pool=pool,
    )


def _finish_body(h: _RoundHandle):
    """The round's fetch half: the verdict, the decode, the gang-transaction
    rollback loop (each re-run verified too) and the explain fetch.  The
    returned result may be a zero-arg callable (a stacked lane the rollback
    never replaced); collect_round_stats resolves it."""
    from armada_tpu_torch.models import explain as _explain
    from armada_tpu_torch.models import verify as _verify

    trace = _trace()
    ctx, kernel_kwargs, device = h.ctx, h.kernel_kwargs, h.device
    result = h.result
    exp_dispatched = h.exp_dispatched
    # the fetch span is where the device time surfaces: the dispatch spans
    # are enqueues, this is the blocking wait
    with trace.span("fetch_decode"):
        if h.ver_check is not None:
            h.ver_check()
        outcome = h.finish()
    if outcome.kernel_iters:
        trace.annotate(
            kernel_iters=outcome.kernel_iters,
            commits_per_iter=round(outcome.num_iterations / outcome.kernel_iters, 2),
        )

    # Gang-transaction rollback: if a split gang's sibling placed but another
    # sub-gang failed, decode unwound the sibling -- but evictions its
    # placement caused are still in the round state.  Re-run with the doomed
    # gangs invalidated, so the outcome equals a round in which they were
    # never attempted.  Running gangs share fate the same way: a round that
    # preempts only some members of a running gang re-runs with all of the
    # gang's evictee slots invalidated.  Each re-run kills >= 1 gang; the
    # attempt cap bounds latency, and past it the partial gangs are forced
    # out so no half-gang ever stands.
    attempts = 0
    while attempts < 4:
        kill: list = []
        if outcome.unwound_groups:
            # Group tags live only on multi-member units under the
            # vectorized representation, and slab contexts have G ~ backlog
            # slots: never range-scan num_real_gangs unless gangs are
            # list-represented.
            tagged = (
                ctx.gang_members_over.keys()
                if ctx.gang_members is None
                else range(ctx.num_real_gangs)
            )
            kill.extend(gi for gi in tagged if ctx.gang_group[gi] in outcome.unwound_groups)
        kill.extend(_partial_running_gangs(ctx, h.device_problem, outcome))
        if not kill:
            break
        attempts += 1
        launch_guard("gang re-run")
        with trace.span("gang_rerun", attempt=attempts, killed=len(set(kill))):
            # a new g_valid tensor: the problem the caller holds is not written
            device_problem = h.device_problem()
            g_valid = device_problem.g_valid.clone()
            g_valid[torch.as_tensor(sorted(set(kill)), dtype=torch.long,
                                    device=g_valid.device)] = False
            device_problem = device_problem._replace(g_valid=g_valid)
            h.dp = device_problem
            result = schedule_round(device_problem, device=device, **kernel_kwargs)
            fin = begin_decode(result, ctx)
            if h.verify_armed:
                # every attempt is verified between its fetch and its decode
                vd = _verify.dispatch_verify(device_problem, result, fin.dispatched, ctx)
                if vd is not None:
                    fin.fetch()
                    with trace.span("verify_fetch"):
                        _verify.finish_verify(vd, ctx, pool=h.pool)
            outcome = fin()
    if attempts and h.explain_armed:
        # attribution describes the final (post-rollback) round: re-dispatch once
        exp_dispatched = _explain.dispatch_explain(h.device_problem(), result, ctx)
    if attempts >= 4:
        _force_preempt_partials(ctx, outcome)
    if exp_dispatched is not None:
        with trace.span("explain_fetch"):
            outcome.explain = _explain.finish_explain(exp_dispatched, ctx, outcome)
    outcome.pool_totals = ctx.pool_total_atoms
    return result, outcome


def _round_body(device_problem, ctx, kernel_kwargs, device, shadow, explain_armed=False):
    """One complete round against device-resident tensors: dispatch and
    finish back to back."""
    return _finish_body(_dispatch_body(device_problem, ctx, kernel_kwargs, device, shadow,
                                       explain_armed))


def _iter_partial_gangs(ctx, outcome):
    """Yield (run_indices, retained_job_ids) for each running gang this round
    preempted only partially.  ctx.running_gangs may be a zero-arg callable
    (the incremental assembles build the mapping lazily); it is resolved
    only when a round preempted something."""
    if not outcome.preempted or not ctx.running_gangs:
        return
    rg = ctx.running_gangs
    if callable(rg):
        rg = ctx.running_gangs = rg()  # cache across re-runs
        if not rg:
            return
    pre = set(outcome.preempted)
    for ris in rg.values():
        retained = [
            jid for ri in ris if (jid := ctx.run_job_id(int(ri))) not in pre
        ]
        if retained and len(retained) < len(ris):
            yield ris, retained


def _partial_running_gangs(ctx, dp_thunk, outcome) -> list:
    """Evictee-slot gang indices to invalidate for the cascade re-run.
    `dp_thunk` resolves the device problem lazily (a stacked lane is sliced
    only when a round preempted part of a running gang)."""
    run_gang = None
    kill: list = []
    for ris, _retained in _iter_partial_gangs(ctx, outcome):
        if run_gang is None:
            run_gang = dp_thunk().run_gang.cpu().numpy()
        for ri in ris:
            gi = int(run_gang[ri])
            if gi >= 0:
                kill.append(gi)
    return kill


def _force_preempt_partials(ctx, outcome) -> None:
    for _ris, retained in _iter_partial_gangs(ctx, outcome):
        for jid in retained:
            outcome.preempted.append(jid)
            if jid in outcome.rescheduled:
                outcome.rescheduled.remove(jid)


def collect_round_stats(result, problem, ctx, config, outcome) -> None:
    """Attach per-queue share stats (and indicative shares) to the outcome.
    The water-filling runs on the device the result lies on.  `result` may
    be a zero-arg callable (a stacked lane's lazy slice): resolved here."""
    if callable(result):
        result = result()
    from armada_tpu_torch.models.problem import queue_stats_from_result

    outcome.queue_stats = queue_stats_from_result(result, problem, ctx)
    if config.indicative_share_base_priorities:
        from armada_tpu_torch.ops.fairness import theoretical_share

        dev = result.q_alloc.device
        w = torch.as_tensor(np.asarray(problem.q_weight), device=dev)
        cds = torch.as_tensor(np.asarray(problem.q_cds), device=dev)
        outcome.indicative_shares = {
            p: theoretical_share(w, cds, float(p))
            for p in config.indicative_share_base_priorities
        }


def run_scheduling_round(
    config,
    *,
    pool,
    nodes,
    queues,
    queued_jobs,
    running=(),
    collect_stats=True,
    bid_price_of=None,
    away_mode=False,
    global_tokens=None,
    queue_tokens=None,
    banned_nodes=None,
    queue_penalty=None,
    device="cuda",
):
    """Build the dense problem, run the round on `device`, decode back to ids:
    one scheduling-algorithm call for one pool.  Runs on the card unless the
    caller passes device='cpu'; with no card, device='cuda' raises."""
    device = _resolve_device(device)
    problem, ctx = build_problem(
        config,
        pool=pool,
        nodes=nodes,
        queues=queues,
        queued_jobs=queued_jobs,
        running=running,
        bid_price_of=bid_price_of,
        away_mode=away_mode,
        global_tokens=global_tokens,
        queue_tokens=queue_tokens,
        banned_nodes=banned_nodes,
        queue_penalty=queue_penalty,
    )
    # away rounds: attribution is a home-round signal (the away apply
    # discards outcome.explain), so they leave the host pool's cadence alone
    result, outcome = run_round_on_device(problem, ctx, config, device=device,
                                          explain_enabled=not away_mode)
    if collect_stats:
        collect_round_stats(result, problem, ctx, config, outcome)
    return outcome


__all__ = [
    "run_scheduling_round",
    "run_round_on_device",
    "dispatch_round_on_device",
    "dispatch_pool_rounds",
    "PoolRoundSpec",
    "reset_stack_cache",
    "collect_round_stats",
    "SchedulingProblem",
    "HostContext",
    "build_problem",
    "begin_decode",
    "decode_result",
    "RoundOutcome",
    "schedule_round",
    "RoundResult",
    "problem_from_numpy",
    "result_to_numpy",
]
