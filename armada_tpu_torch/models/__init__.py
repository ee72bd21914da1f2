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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'"
        )
    return device


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
    """The mesh rounds on `device` run over (None: mesh serving off or its
    ladder exhausted)."""
    from armada_tpu_torch.parallel.serving import mesh_serving

    ms = mesh_serving()
    return ms.serving_mesh(device) if ms.enabled() else None


def _round_env(problem, ctx, config, explain_enabled, device):
    """The per-round prologue shared by run_round_on_device and the
    pool-parallel dispatchers: the kernel statics -- with the serving mesh
    as `mesh` while one is armed: the round learns of the mesh here,
    explicitly -- and the ONE explain cadence tick this round gets (exactly
    once per pool round, even when a stacked dispatch hands the lane to a
    solo one).  Away rounds pass explain_enabled=False and never tick:
    their outcome.explain is discarded, and a tick would shift the host
    pool's cadence."""
    from armada_tpu_torch.models import explain as _explain

    explain_armed = bool(explain_enabled) and _explain.explain_due(getattr(ctx, "pool", ""))
    kw = _kernel_kwargs(problem, ctx, config)
    mesh = _serving_mesh(device)
    if mesh is not None:
        kw["mesh"] = mesh
    return kw, explain_armed


def _build_device_problem(problem, device_problem, device, mesh=None):
    """The round's device problem: the caller's (a value, or a zero-arg
    callable such as DeviceDeltaCache.apply), else a fresh upload -- sharded
    onto the serving mesh when one is armed (from-scratch and away rounds),
    so every round sees the same placement.  Incremental rounds arrive on
    the mesh through MeshDeviceDeltaCache, their node axis aligned to it by
    the builders; a problem that does not divide into the mesh is a build
    bug and raises."""
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


def _run_round_on_mesh(host_problem, ctx, config, kernel_kwargs, mesh, explain_armed=False):
    """Re-run the SAME round over a (smaller) mesh from host tables: the
    rung of the degrade ladder between the full mesh and the single card,
    one full sharded upload.  The JAX package's failover loop calls it on a
    failed round; the port's waits for ROADMAP item 8."""
    from armada_tpu_torch.parallel.mesh import shard_problem

    kw = dict(kernel_kwargs, mesh=mesh)
    return _round_body(shard_problem(host_problem, mesh), ctx, kw, mesh.device, (),
                       explain_armed)


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
    producing it (DeviceDeltaCache.apply inside the round); without it the
    problem is uploaded.  `shadow_work`: zero-arg callables run once between
    the dispatch and the first blocking fetch (decision-independent work,
    such as the next submits and their slab prefetch).  `host_problem` (a
    problem or a thunk, e.g. DeltaBundle.materialize) is accepted for the
    JAX package's signature; the port has no CPU failover rung that would
    read it yet (ROADMAP item 8).  `explain_enabled=False` (away rounds)
    leaves the explain cadence untouched.  RoundVerificationError
    propagates: nothing is re-run quietly.  While the mesh serving plane is
    armed the round runs over the serving mesh; a failed round does not yet
    walk the JAX package's degrade ladder (ROADMAP item 8)."""
    device = _resolve_device(device)
    kernel_kwargs, explain_armed = _round_env(problem, ctx, config, explain_enabled, device)
    dp = _build_device_problem(problem, device_problem, device, kernel_kwargs.get("mesh"))
    return _round_body(dp, ctx, kernel_kwargs, device, shadow_work, explain_armed)


def dispatch_round_on_device(problem, ctx, config, device="cuda", device_problem=None,
                             shadow_work=(), host_problem=None, explain_enabled=True):
    """Phase-split run_round_on_device: dispatch NOW -- the device problem,
    the round, its compaction, the verify and explain enqueues, the shadow
    work -- and return a zero-arg ``finish()`` -> (result, outcome) that
    performs the blocking fetch, the verdict, the decode and the rollback
    loop LATER.  Between the two the caller may dispatch other pools'
    rounds.  Decisions equal run_round_on_device's: the split only reorders
    asynchronous enqueues that never read another round's output.

    The port runs the JAX package's inline discipline only (no watchdog
    deadline): dispatch errors propagate, and a RoundVerificationError
    propagates out of ``finish()`` -- there is no failover ladder yet
    (ROADMAP item 8)."""
    device = _resolve_device(device)
    env = _round_env(problem, ctx, config, explain_enabled, device)
    return _dispatch_one(problem, ctx, device_problem, env, device, shadow_work)


def _dispatch_one(problem, ctx, device_problem, env, device, shadow_work=()):
    """dispatch_round_on_device with a precomputed _round_env (the explain
    tick happened there, once per round)."""
    kernel_kwargs, explain_armed = env
    dp = _build_device_problem(problem, device_problem, device, kernel_kwargs.get("mesh"))
    handle = _dispatch_body(dp, ctx, kernel_kwargs, device, shadow_work, explain_armed)
    return lambda: _finish_body(handle)


@dataclasses.dataclass
class PoolRoundSpec:
    """One pool's round inputs for dispatch_pool_rounds -- the arguments its
    run_round_on_device call would take."""

    problem: object  # stats_view / SchedulingProblem (host side)
    ctx: object  # HostContext
    device_problem: object = None  # device buffers, or a thunk producing them
    host_problem: object = None  # accepted for the JAX signature (no failover rung yet)
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
    covered.

    The port runs the JAX package's inline discipline only (no watchdog
    deadline, no supervisor, no fault drills), so stacking reduces to
    ``allow_stacking and len(specs) > 1`` while the mesh serving plane is
    off -- under the mesh every pool's round runs sharded and alone, as in
    the JAX package; ``dispatch_failed`` is always empty (no dispatch walks
    a failover ladder), and a RoundVerificationError propagates out of the
    failing pool's finish (ROADMAP item 8)."""
    from armada_tpu_torch.parallel.serving import mesh_serving

    device = _resolve_device(device)
    envs = [_round_env(s.problem, s.ctx, config, s.explain_enabled, device) for s in specs]
    finishes: list = [None] * len(specs)
    dispatch_failed: set = set()
    if not (allow_stacking and len(specs) > 1 and not mesh_serving().enabled()):
        for i, s in enumerate(specs):
            finishes[i] = _dispatch_one(s.problem, s.ctx, s.device_problem, envs[i], device,
                                        s.shadow_work)
        return finishes, 0, 0, dispatch_failed

    # Phase 1: every pool's device problem (the O(delta) cache scatters).
    dps = [_build_device_problem(s.problem, s.device_problem, device) for s in specs]

    # Phase 2: group by (statics, device, exact field shapes and dtypes);
    # insertion order keeps groups in first-member pool order.  torch.Size
    # and dtype objects hash as they are: no per-cycle string work.
    groups: dict = {}
    for i, dp in enumerate(dps):
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
            finishes[i] = _dispatch_one(specs[i].problem, specs[i].ctx, dps[i], envs[i], device,
                                        specs[i].shadow_work)
            continue
        group_finishes = _dispatch_stacked_group(idxs, specs, envs, dps, device, key)
        stacked_launches += 1
        stacked_pools += len(idxs)
        for i, fin in zip(idxs, group_finishes):
            finishes[i] = fin
    return finishes, stacked_launches, stacked_pools, dispatch_failed


# (group key) -> (per-pool device problems, stacked problem).  Steady cycles
# present the SAME device problem objects every cycle (DeviceDeltaCache's
# no-op apply hands back its resident problem), so the stack is reused by
# identity.  Entries hold strong references, which makes the identity test
# safe: a cached tensor cannot be freed and its address reused while the
# entry lives.  The size cap bounds what it pins.
_STACK_CACHE: dict = {}
_STACK_CACHE_CAP = 8


def reset_stack_cache() -> None:
    """Drop every memoized stack (and the device buffers it pins)."""
    _STACK_CACHE.clear()


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
    stacked = stack(dps)
    if len(_STACK_CACHE) >= _STACK_CACHE_CAP:
        _STACK_CACHE.clear()
    _STACK_CACHE[key] = (dps, stacked)
    return stacked


def _dispatch_stacked_group(idxs, specs, envs, dps, device, group_key):
    """ONE stacked launch for a shape-matched pool group: stack the device
    problems (K-E), run the stacked round (K-D), dispatch the stacked
    compaction (K-F) and verification (K-I stacked), and hand back per-pool
    finish callables that share the two fetched buffers.  Lane views of the
    problem and the result are sliced lazily (K-G): only the explain pass,
    a rollback re-run and a cap overflow read them."""
    from armada_tpu_torch.models import explain as _explain
    from armada_tpu_torch.models import verify as _verify
    from armada_tpu_torch.models.fair_scheduler import schedule_round_stacked
    from armada_tpu_torch.models.problem import begin_decode_stacked, lane_slice
    from armada_tpu_torch.models.xfer import TRANSFER_STATS

    kk = envs[idxs[0]][0]
    ctxs = [specs[i].ctx for i in idxs]
    stacked = _stack_problems(group_key, [dps[i] for i in idxs])
    result = schedule_round_stacked(stacked, **kk)
    verify_armed = _verify.verify_enabled()
    fins = begin_decode_stacked(result, ctxs)
    ver_buf = None
    if verify_armed:
        ver_buf = _verify.dispatch_verify_stacked(stacked, result, fins[0].dispatched[0], ctxs)
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
        explain_armed = envs[i][1]
        fin = fins[j]
        lane_result = lambda j=j: lane_slice(result, j)  # noqa: E731
        ver_check = None
        if ver_buf is not None:

            def ver_check(j=j, ctx=ctx, pool=pool, fin=fin):
                fin.fetch()  # this pool's compact row (one shared transfer)
                _verify.verdict_of(ver_rows()[j], ctx, pool=pool)

        exp_dispatched = None
        if explain_armed:
            exp_dispatched = _explain.dispatch_explain(lane_slice(stacked, j), lane_result(), ctx)
        handle = _RoundHandle(
            dp=(lambda j=j: lane_slice(stacked, j)), ctx=ctx, kernel_kwargs=kk, device=device,
            result=lane_result, finish=fin, ver_check=ver_check, exp_dispatched=exp_dispatched,
            explain_armed=explain_armed, verify_armed=verify_armed, pool=pool,
        )
        for fn in s.shadow_work:  # this pool's shadow work rides the stack
            fn()
        out.append(lambda handle=handle: _finish_body(handle))
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
            self.dp = self.dp()
        return self.dp


def _dispatch_body(device_problem, ctx, kernel_kwargs, device, shadow_work=(),
                   explain_armed=False) -> _RoundHandle:
    """The round's dispatch half: the round, the compaction and the
    verify/explain passes are enqueued on the stream without a host sync,
    then the shadow work runs."""
    from armada_tpu_torch.models import explain as _explain
    from armada_tpu_torch.models import verify as _verify

    pool = getattr(ctx, "pool", "")
    result = schedule_round(device_problem, device=device, **kernel_kwargs)
    verify_armed = _verify.verify_enabled()
    finish = begin_decode(result, ctx)
    # Verification rides behind the compaction; its verdict is checked
    # between the compact fetch and the host decode, so a corrupted round
    # never reaches decode.
    ver_check = None
    if verify_armed:
        ver_dispatched = _verify.dispatch_verify(device_problem, result, finish.dispatched, ctx)
        if ver_dispatched is not None:

            def ver_check():
                finish.fetch()  # blocking compact fetch (stashes the raw bytes)
                _verify.finish_verify(ver_dispatched, ctx, pool=pool)

    exp_dispatched = None
    if explain_armed:
        exp_dispatched = _explain.dispatch_explain(device_problem, result, ctx)
    for fn in shadow_work:
        fn()
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

    ctx, kernel_kwargs, device = h.ctx, h.kernel_kwargs, h.device
    result = h.result
    exp_dispatched = h.exp_dispatched
    if h.ver_check is not None:
        h.ver_check()
    outcome = h.finish()

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
                _verify.finish_verify(vd, ctx, pool=h.pool)
        outcome = fin()
    if attempts and h.explain_armed:
        # attribution describes the final (post-rollback) round: re-dispatch once
        exp_dispatched = _explain.dispatch_explain(h.device_problem(), result, ctx)
    if attempts >= 4:
        _force_preempt_partials(ctx, outcome)
    if exp_dispatched is not None:
        outcome.explain = _explain.finish_explain(exp_dispatched, ctx, outcome)
    outcome.pool_totals = ctx.pool_total_atoms
    return result, outcome


def _round_body(device_problem, ctx, kernel_kwargs, device, shadow_work=(),
                explain_armed=False):
    """One complete round against device-resident tensors: dispatch and
    finish back to back."""
    return _finish_body(_dispatch_body(device_problem, ctx, kernel_kwargs, device,
                                       shadow_work, explain_armed))


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
