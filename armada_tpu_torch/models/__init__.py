"""Scheduling models: the scheduling round in PyTorch.

`problem` builds the dense problem from host job/node/queue objects (numpy),
`state` moves it to a device, `fair_scheduler` runs the round (the CUDA
kernels on a card, the plain version on the CPU), and `problem` decodes the
result back to ids.  The steady-state path keeps the problem on the device
across cycles instead: `incremental.IncrementalBuilder` turns each cycle's
submits, leases and removals into a `slab.DeltaBundle`, and
`slab.DeviceDeltaCache` scatters it into the resident problem.  Every round
can be verified (`verify`) and, on its cadence, explained (`explain`).  This
is the serial single-pool path: one round for one pool, with the
gang-transaction rollback loop.
"""

from __future__ import annotations

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


def _kernel_kwargs(problem, ctx) -> dict:
    return dict(
        num_levels=len(ctx.ladder) + 2,
        max_slots=ctx.max_slots,
        slot_width=ctx.slot_width,
    )


def run_round_on_device(problem, ctx, config, device="cuda", device_problem=None,
                        shadow_work=(), host_problem=None):
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
    read it yet (ROADMAP item 8).  RoundVerificationError propagates:
    nothing is re-run quietly."""
    device = _resolve_device(device)
    if config.enable_prefer_large_job_ordering and not bool(problem.market):
        raise NotImplementedError("prefer_large ordering is not ported yet")
    from armada_tpu_torch.models import explain as _explain

    explain_armed = _explain.explain_due(getattr(ctx, "pool", ""))
    dp = device_problem() if callable(device_problem) else device_problem
    if dp is None:
        dp = problem_from_numpy(problem, device)
    return _round_body(dp, ctx, _kernel_kwargs(problem, ctx), device, shadow_work,
                       explain_armed)


class _RoundHandle:
    """What the dispatch half hands the finish half."""

    __slots__ = ("dp", "ctx", "kernel_kwargs", "device", "result", "finish", "ver_check",
                 "exp_dispatched", "explain_armed", "verify_armed", "pool")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


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
    rollback loop (each re-run verified too) and the explain fetch."""
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
    device_problem = h.dp
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
        kill.extend(_partial_running_gangs(ctx, device_problem, outcome))
        if not kill:
            break
        attempts += 1
        # a new g_valid tensor: the problem the caller holds is not written
        g_valid = device_problem.g_valid.clone()
        g_valid[torch.as_tensor(sorted(set(kill)), dtype=torch.long,
                                device=g_valid.device)] = False
        device_problem = device_problem._replace(g_valid=g_valid)
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
        exp_dispatched = _explain.dispatch_explain(device_problem, result, ctx)
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


def _partial_running_gangs(ctx, device_problem, outcome) -> list:
    """Evictee-slot gang indices to invalidate for the cascade re-run."""
    run_gang = None
    kill: list = []
    for ris, _retained in _iter_partial_gangs(ctx, outcome):
        if run_gang is None:
            run_gang = device_problem.run_gang.cpu().numpy()
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
    The water-filling runs on the device the result lies on."""
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
    result, outcome = run_round_on_device(problem, ctx, config, device=device)
    if collect_stats:
        collect_round_stats(result, problem, ctx, config, outcome)
    return outcome


__all__ = [
    "run_scheduling_round",
    "run_round_on_device",
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
