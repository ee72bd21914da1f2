"""Scheduling models: the scheduling round in PyTorch.

`problem` builds the dense problem from host job/node/queue objects (numpy),
`state` moves it to a device, `fair_scheduler` runs the round (the CUDA
kernels on a card, the plain version on the CPU), and `problem` decodes the
result back to ids.  This is the serial single-pool path: one round for one
pool, with the gang-transaction rollback loop.
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


def run_round_on_device(problem, ctx, config, device="cuda", device_problem=None):
    """(result, outcome): run the round on a built problem and decode it,
    including the gang-transaction rollback loop.  `problem` is the host
    (numpy) problem; `device_problem` may supply it already on `device`."""
    device = _resolve_device(device)
    if config.enable_prefer_large_job_ordering and not bool(problem.market):
        raise NotImplementedError("prefer_large ordering is not ported yet")
    dp = device_problem if device_problem is not None else problem_from_numpy(problem, device)
    return _round_body(dp, ctx, _kernel_kwargs(problem, ctx), device)


def _round_body(device_problem, ctx, kernel_kwargs, device):
    """One complete round against device-resident tensors: kernel, decode,
    and the rollback loop."""
    result = schedule_round(device_problem, device=device, **kernel_kwargs)
    outcome = begin_decode(result, ctx)()

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
            kill.extend(
                gi for gi in range(ctx.num_real_gangs)
                if ctx.gang_group[gi] in outcome.unwound_groups
            )
        kill.extend(_partial_running_gangs(ctx, device_problem, outcome))
        if not kill:
            break
        attempts += 1
        g_valid = device_problem.g_valid.clone()
        g_valid[torch.as_tensor(sorted(set(kill)), dtype=torch.long,
                                device=g_valid.device)] = False
        device_problem = device_problem._replace(g_valid=g_valid)
        result = schedule_round(device_problem, device=device, **kernel_kwargs)
        outcome = begin_decode(result, ctx)()
    if attempts >= 4:
        _force_preempt_partials(ctx, outcome)
    outcome.pool_totals = ctx.pool_total_atoms
    return result, outcome


def _iter_partial_gangs(ctx, outcome):
    """Yield (run_indices, retained_job_ids) for each running gang this round
    preempted only partially."""
    if not outcome.preempted or not ctx.running_gangs:
        return
    pre = set(outcome.preempted)
    for ris in ctx.running_gangs.values():
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
