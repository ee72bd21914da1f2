"""The scheduling round: fair-share eviction, greedy placement, oversubscription
repair.  PyTorch counterpart of the JAX package's models/fair_scheduler.py.

Phases (the reference's preempting queue scheduler):
  1. Fair-share eviction: queues whose DRF cost exceeds `protected_fraction` of
     their fair share have their preemptible running jobs evicted -- usage
     moves to the evicted level 0 and their pinned re-scheduling candidates
     are activated.
  2. The placement loop: each iteration picks the queue whose next gang gives
     the lowest proposed DRF cost (or the highest bid in market pools) and
     places that gang all-or-nothing: clean fit first (at level 0, where
     evicted markers still count), else urgency preemption at the gang's own
     level.  A failed single-job gang registers its scheduling key unfeasible,
     retiring every identical pending job.  Burst and resource caps gate new
     jobs only; evictees always keep their chance to re-place.
  3. Oversubscription repair: nodes driven negative at some level evict their
     preemptible runs at that level, which then re-place on their pinned nodes
     through a fixed point.
  4. Evicted runs that did not come back are preempted; their markers go.

`schedule_round` takes a problem whose tensors lie on one device.  On a CUDA
device it runs the hand-written kernels (kernels/round.py, the ports of the
jitted `_schedule_round_jit`); on the CPU it runs `schedule_round_plain`,
the plain PyTorch version below, which is the readable specification of what
the kernels compute.  Every loop shape of the JAX package's body is
ported: the node-type bias (TR > 1), prefer-large ordering, the multi-commit
extension (commit_k > 1, ARMADA_COMMIT_K; `_extension`), and the
decision-neutral variants -- the per-key fit cache (cache_slots > 0,
ARMADA_CACHE_SLOTS; `_FitCache`), the certified pick chain (batch_k > 1,
ARMADA_BATCH_K; `_pick_chain`) and unroll.  None changes a decision;
commit_k and batch_k make the trips (kernel_iters) fewer.

`schedule_round_stacked` runs P pools whose problems match in every shape
as one stacked round (a leading lane axis on every field): kernel K-D on a
card, `schedule_round_stacked_plain` (a loop of the solo plain round over
the lanes) on the CPU.  The lanes are independent, so each equals the solo
round on its slice.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from armada_tpu_torch.models.problem import SchedulingProblem
from armada_tpu_torch.ops.fairness import fair_shares, unweighted_drf_cost, weighted_drf_cost
from armada_tpu_torch.ops.fit import allocatable_from_used
from armada_tpu_torch.ops.packing import (
    member_capacity,
    node_packing_score,
    select_best_node,
    select_gang_nodes_compact,
)

_BIGI = 2**31 - 1
_INF = float(np.float32(3.0e38))
# Prefer-large ordering: lifts over-budget keys above every within-budget key,
# far below the masked-out _INF.
_PL_OVER = float(np.float32(1.0e30))

TERM_EXHAUSTED = 0
TERM_GLOBAL_BURST = 1
TERM_ROUND_CAP = 2
TERM_MAX_ITER = 3

# How many queue-head entries each queue can skip (decided gangs, unfeasible
# keys) per iteration.
SKIP_WINDOW = 16

# Header words of the packed decode buffer (see compact_result).
COMPACT_HEADER = 9


class RoundResult(NamedTuple):
    g_state: torch.Tensor  # i32[G]: 0 not attempted, 1 scheduled, 2 failed, 3 absent
    slot_gang: torch.Tensor  # i32[S]
    slot_nodes: torch.Tensor  # i32[S, W]
    slot_counts: torch.Tensor  # i32[S, W]
    n_slots: torch.Tensor  # i32
    run_evicted: torch.Tensor  # bool[RJ]
    run_rescheduled: torch.Tensor  # bool[RJ]
    alloc: torch.Tensor  # f32[P1, N, R] final allocatable by level
    q_alloc: torch.Tensor  # f32[Q, R]
    iterations: torch.Tensor  # i32
    termination: torch.Tensor  # i32
    scheduled_count: torch.Tensor  # i32 newly scheduled members
    spot_price: torch.Tensor  # f32; -1 = unset
    q_killed: torch.Tensor  # bool[Q]
    kernel_iters: torch.Tensor  # i32 loop-body applications


def round_statics(p: SchedulingProblem, *, max_iterations: int = 0,
                  prefer_large: bool = False, cache_slots: int = -1,
                  unroll: int = -1, batch_k: int = -1, commit_k: int = -1) -> dict:
    """Resolve the loop statics as the JAX package's `_resolve_round_statics`
    does, from the per-lane shapes of a stacked problem: -1 reads the
    environment (ARMADA_CACHE_SLOTS, clamped to the compat rows;
    ARMADA_BATCH_K; ARMADA_COMMIT_K) or the default, 0 / 1 / 1 / 1;
    commit_k is clamped to [1, Q]; the fit cache or prefer_large force
    batch_k = 1, prefer_large forces commit_k = 1, and commit_k > 1 forces
    batch_k = 1.  The defaults differ from the JAX package's on its CPU
    platform, which arms a 64-slot cache there: decisions are the same
    either way.  Returns dict(max_iterations, prefer_large, commit_k,
    cache_slots, batch_k, unroll), the iteration bound being 2G + Q + 8
    when max_iterations <= 0."""
    o = 1 if p.q_weight.dim() == 2 else 0  # a stacked problem's lane axis
    G = int(p.g_req.shape[o])
    Q = int(p.q_weight.shape[o])
    if cache_slots < 0:
        env = os.environ.get("ARMADA_CACHE_SLOTS")
        cache_slots = min(int(env), int(p.compat.shape[o])) if env else 0
    if unroll < 0:
        unroll = 1
    if batch_k < 0:
        env = os.environ.get("ARMADA_BATCH_K")
        batch_k = int(env) if env else 1
    if cache_slots > 0 or prefer_large:
        batch_k = 1
    if commit_k < 0:
        commit_k = resolve_commit_k()
    commit_k = max(1, min(commit_k, Q))
    if prefer_large:
        commit_k = 1
    if commit_k > 1:
        batch_k = 1
    return dict(
        max_iterations=max_iterations if max_iterations > 0 else 2 * G + Q + 8,
        prefer_large=bool(prefer_large),
        commit_k=commit_k,
        cache_slots=max(0, int(cache_slots)),
        batch_k=max(1, int(batch_k)),
        unroll=max(1, int(unroll)),
    )


def resolve_round_statics(p: SchedulingProblem, **kw) -> int:
    """The iteration bound of `round_statics` (2G + Q + 8 when
    max_iterations <= 0), after the same checks."""
    return round_statics(p, **kw)["max_iterations"]


def resolve_commit_k() -> int:
    """The multi-commit width armed by ARMADA_COMMIT_K (default 1), floored
    at 1; an unparsable value reads as 1, as in the JAX package."""
    env = os.environ.get("ARMADA_COMMIT_K")
    try:
        return max(1, int(env)) if env else 1
    except ValueError:
        return 1


def schedule_round(
    p: SchedulingProblem,
    *,
    num_levels: int,
    max_slots: int,
    slot_width: int,
    max_iterations: int = 0,
    prefer_large: bool = False,
    cache_slots: int = -1,
    unroll: int = -1,
    batch_k: int = -1,
    commit_k: int = -1,
    device="cuda",
    mesh=None,
) -> RoundResult:
    """Run one scheduling round.  `p` may hold numpy arrays (it is moved to
    `device` first) or tensors, which must lie on `device`.  A CUDA device
    runs the kernels; the CPU runs the plain version.  The statics resolve
    as in `round_statics`.  `mesh` (parallel.mesh.Mesh): the round runs
    over its node shards (kernel K-K on a card); the problem's node axis
    must divide into them."""
    from armada_tpu_torch.models.state import problem_from_numpy, problem_device

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "schedule_round: no CUDA device; pass device='cpu' to run the plain version"
        )
    if isinstance(p.g_req, np.ndarray):
        p = problem_from_numpy(p, device)
    have = problem_device(p)
    if have.type != device.type:
        raise ValueError(f"schedule_round: problem lies on {have}, not {device}")
    statics = round_statics(
        p, max_iterations=max_iterations, prefer_large=prefer_large,
        cache_slots=cache_slots, unroll=unroll, batch_k=batch_k, commit_k=commit_k,
    )
    from armada_tpu_torch.kernels.round import schedule_round as wrapper

    if mesh is not None:
        statics["mesh"] = mesh
    return wrapper(p, num_levels=num_levels, max_slots=max_slots, slot_width=slot_width,
                   **statics)


def schedule_round_stacked(
    p: SchedulingProblem,
    *,
    num_levels: int,
    max_slots: int,
    slot_width: int,
    max_iterations: int = 0,
    prefer_large: bool = False,
    cache_slots: int = -1,
    unroll: int = -1,
    batch_k: int = -1,
    commit_k: int = -1,
) -> RoundResult:
    """Run P independent pools' rounds as one stacked round.  Every field of
    `p` carries a leading lane axis (lane i is pool i's padded problem, all
    lanes equal in shape); so does every field of the result.  The statics
    resolve as for `schedule_round`, from the per-lane shapes, and every
    lane runs with them.  A CUDA problem runs kernel K-D; a CPU problem the
    plain version."""
    if p.q_weight.dim() != 2 or int(p.g_req.shape[0]) < 1:
        raise ValueError("schedule_round_stacked: expected a [P, ...] stacked problem")
    statics = round_statics(
        p, max_iterations=max_iterations, prefer_large=prefer_large,
        cache_slots=cache_slots, unroll=unroll, batch_k=batch_k, commit_k=commit_k,
    )
    from armada_tpu_torch.kernels.round import schedule_round_stacked as wrapper

    return wrapper(p, num_levels=num_levels, max_slots=max_slots, slot_width=slot_width,
                   **statics)


def schedule_round_stacked_plain(
    p: SchedulingProblem, *, num_levels: int, max_slots: int, slot_width: int,
    max_iterations: int, prefer_large: bool = False, commit_k: int = 1,
    cache_slots: int = 0, batch_k: int = 1, unroll: int = 1,
) -> RoundResult:
    """The plain version of kernel K-D: the solo plain round on each lane,
    stacked, every lane with the same statics and its own fit cache.
    Exact because the lanes share nothing."""
    lanes = [
        schedule_round_plain(
            SchedulingProblem(*(t[i] for t in p)), num_levels=num_levels,
            max_slots=max_slots, slot_width=slot_width, max_iterations=max_iterations,
            prefer_large=prefer_large, commit_k=commit_k, cache_slots=cache_slots,
            batch_k=batch_k, unroll=unroll,
        )
        for i in range(int(p.g_req.shape[0]))
    ]
    return RoundResult(*(torch.stack([getattr(r, f) for r in lanes]) for f in RoundResult._fields))


# --- the plain version -------------------------------------------------------


def _level_mask(num_levels: int, level: int, lo: int, device) -> torch.Tensor:
    lv = torch.arange(num_levels, device=device)
    return ((lv >= lo) & (lv <= level)).to(torch.float32)


def move_runs_to_evicted(alloc, q_alloc, q_alloc_pc, p: SchedulingProblem, move, num_levels):
    """Move the usage of runs in `move` (f32[RJ] 0/1) from their level to the
    evicted level 0: allocatable at levels 1..run_level gains it back, level 0
    keeps it (the marker still counts against clean fit), and the queue's
    allocation drops.  Scatter-adds of integral values: exact in any order."""
    delta = p.run_req * move[:, None]
    delta_node = delta * p.node_axes[None, :]
    lv = torch.arange(num_levels, device=alloc.device)
    mask = ((lv[:, None] >= 1) & (lv[:, None] <= p.run_level[None, :])).to(torch.float32)
    alloc = alloc.clone()
    alloc.index_add_(1, p.run_node.long(), mask[:, :, None] * delta_node[None, :, :])
    q_alloc = q_alloc.clone()
    q_alloc.index_add_(0, p.run_queue.long(), -delta)
    Q, C, R = q_alloc_pc.shape
    flat = q_alloc_pc.reshape(Q * C, R).clone()
    flat.index_add_(0, (p.run_queue.long() * C + p.run_pc.long()), -delta)
    return alloc, q_alloc, flat.reshape(Q, C, R)


def round_prologue(p: SchedulingProblem, num_levels: int, shares=None):
    """Running usage, fair-share eviction and gang activation.  Returns
    (alloc, q_alloc, q_alloc_pc, float_used, run_evicted, g_state).
    `shares`: the round's fair shares when the caller has them already."""
    dev = p.g_req.device
    N, R = p.node_total.shape
    Q = p.q_weight.shape[0]
    C = p.pc_queue_cap.shape[0]
    runf = p.run_valid.to(torch.float32)
    run_req_node = p.run_req * p.node_axes[None, :]
    used = torch.zeros((num_levels * N, R), dtype=torch.float32, device=dev)
    used.index_add_(0, p.run_level.long() * N + p.run_node.long(), run_req_node * runf[:, None])
    alloc = allocatable_from_used(p.node_total, used.reshape(num_levels, N, R))
    float_used = (p.run_req * (1.0 - p.node_axes)[None, :] * runf[:, None]).sum(0)
    run_w = p.run_req * runf[:, None]
    q_alloc = torch.zeros((Q, R), dtype=torch.float32, device=dev)
    q_alloc.index_add_(0, p.run_queue.long(), run_w)
    q_alloc_pc = torch.zeros((Q * C, R), dtype=torch.float32, device=dev)
    q_alloc_pc.index_add_(0, p.run_queue.long() * C + p.run_pc.long(), run_w)
    q_alloc_pc = q_alloc_pc.reshape(Q, C, R)

    if shares is None:
        shares = fair_shares(p.q_weight, p.q_cds)
    actual = unweighted_drf_cost(q_alloc, p.total_pool, p.drf_mult)
    fairsh = torch.maximum(shares.demand_capped_adjusted_fair_share, shares.fair_share)
    pos = fairsh > 0
    frac = torch.where(
        pos, actual / torch.where(pos, fairsh, torch.ones_like(fairsh)),
        torch.full_like(fairsh, _INF),
    )
    over = (frac > p.protected_fraction) & (p.q_weight > 0)
    run_evicted = (
        p.run_valid & p.run_preemptible & over[p.run_queue.long()] & (p.run_gang >= 0)
    )
    alloc, q_alloc, q_alloc_pc = move_runs_to_evicted(
        alloc, q_alloc, q_alloc_pc, p, run_evicted.to(torch.float32), num_levels
    )

    g_run = p.g_run.long()
    evictee_active = torch.where(
        g_run >= 0, run_evicted[torch.clamp(g_run, min=0)], torch.zeros_like(p.g_valid)
    )
    pending0 = p.g_valid & ((g_run < 0) | evictee_active)
    g_state = torch.where(pending0, 0, 2).to(torch.int32)
    g_state = torch.where(p.g_valid & (g_run >= 0) & ~evictee_active, 3, g_state)
    g_state = torch.where(p.g_valid, g_state, 2)
    g_state = torch.where(p.g_absent, 3, g_state).to(torch.int32)
    return alloc, q_alloc, q_alloc_pc, float_used, run_evicted, g_state


def _fit_row(alloc_rows, req):
    pos = req > 0
    safe_req = torch.where(pos, req, torch.ones_like(req))
    per = torch.where(pos, torch.floor(alloc_rows / safe_req), torch.full_like(alloc_rows, _INF))
    return per.amin(dim=-1) >= 1.0


def schedule_round_plain(
    p: SchedulingProblem, *, num_levels: int, max_slots: int, slot_width: int,
    max_iterations: int, prefer_large: bool = False, commit_k: int = 1,
    cache_slots: int = 0, batch_k: int = 1, unroll: int = 1,
) -> RoundResult:
    """The round as plain PyTorch on the problem's device: one Python
    iteration per step of the reference's placement `while_loop`, with the
    loop body's data-dependent branches taken on host-side scalars.
    `prefer_large` orders queues by the prefer-large rule; `commit_k` > 1
    appends the multi-commit extension (`_extension`) to every step.

    The decision-neutral shapes: `cache_slots` > 0 places cacheable singles
    from the per-key fit cache (`_FitCache`); `batch_k` > 1 appends the
    certified pick chain (`_pick_chain`) to every step; `unroll` > 1 reads
    the loop condition every `unroll` steps, a step past the end being a
    no-op.  None changes a decision; batch_k and commit_k change only
    kernel_iters."""
    dev = p.g_req.device
    G = p.g_req.shape[0]
    N, R = p.node_total.shape
    Q = p.q_weight.shape[0]
    RJ = p.run_req.shape[0]
    W = SKIP_WINDOW
    f32 = torch.float32
    i32 = torch.int32

    shares = fair_shares(p.q_weight, p.q_cds)
    alloc, q_alloc, q_alloc_pc, float_used, run_evicted, g_state = round_prologue(
        p, num_levels, shares
    )

    # loop-invariant tables
    g_req_node = p.g_req * p.node_axes[None, :]
    g_float_tot = (p.g_req * (1.0 - p.node_axes)[None, :]) * p.g_card[:, None].to(f32)
    g_req_tot = p.g_req * p.g_card[:, None].to(f32)
    gq_gang = p.gq_gang.long()
    g_key = p.g_key.long()
    g_run_t = p.g_run.long()
    q_start = p.q_start.long()
    q_len = p.q_len.long()
    node_type = p.node_type.long()
    float_cap = p.float_total + torch.tensor(1e-3, dtype=f32, device=dev)
    pool_safe = torch.maximum(p.total_pool, torch.tensor(1e-9, dtype=f32, device=dev))
    arangeW = torch.arange(W, device=dev)
    qidx = torch.arange(Q, device=dev)
    # node-type bias (TR > 1): the per-node table of every bias row, and the
    # row of each key (row 0: keyless and type-insensitive keys)
    hetero = int(p.type_bias.shape[0]) > 1
    type_bias_nodes = p.type_bias[:, node_type] if hetero else None
    if prefer_large:
        # itemSize: the unweighted gang cost times its queue's weight; the
        # weighted budget: the demand-capped share over the weight
        g_size = unweighted_drf_cost(g_req_tot, p.total_pool, p.drf_mult) * \
            p.q_weight[p.g_queue.long()]
        q_budget = torch.where(
            p.q_weight > 0,
            shares.demand_capped_adjusted_fair_share
            / torch.maximum(p.q_weight, torch.tensor(1e-9, dtype=f32, device=dev)),
            torch.zeros_like(p.q_weight),
        )
    host = {
        name: getattr(p, name).cpu().numpy()
        for name in ("g_card", "g_level", "g_key", "g_pc", "g_run", "g_ban_row",
                     "run_node", "perq_burst", "key_type_row")
    }
    market = bool(p.market)
    global_burst = int(p.global_burst)
    spot_cutoff = float(p.spot_cutoff)

    q_killed = ~(p.q_weight > 0)
    q_sched = torch.zeros((Q,), dtype=torch.int64, device=dev)
    q_head = torch.zeros((Q,), dtype=torch.int64, device=dev)
    key_bad = torch.zeros((p.compat.shape[0],), dtype=torch.bool, device=dev)
    run_rescheduled = torch.zeros_like(run_evicted)
    slot_gang = torch.zeros((max_slots,), dtype=i32, device=dev)
    slot_nodes = torch.full((max_slots, slot_width), N, dtype=i32, device=dev)
    slot_counts = torch.zeros((max_slots, slot_width), dtype=i32, device=dev)
    cursor = 0
    sched_count = 0
    sched_res = torch.zeros((R,), dtype=f32, device=dev)
    spot_res = torch.zeros((R,), dtype=f32, device=dev)
    new_blocked = False
    iterations = 0
    kernel_iters = 0
    done = False
    termination = TERM_EXHAUSTED
    spot_price = torch.tensor(-1.0, dtype=f32, device=dev)
    empty_nodes = torch.full((slot_width,), N, dtype=i32, device=dev)
    empty_counts = torch.zeros((slot_width,), dtype=i32, device=dev)
    cache = _FitCache(p, alloc, cache_slots) if cache_slots > 0 else None

    steps_left = 0
    while True:
        # unroll: the loop condition is read every `unroll` steps; a step
        # past done or the iteration bound is a no-op (the body's gate)
        if steps_left == 0:
            if done or iterations >= max_iterations:
                break
            steps_left = unroll
        steps_left -= 1
        if done or iterations >= max_iterations:
            continue
        # --- advance per-queue cursors past decided / unfeasible heads -----
        offs = q_head[:, None] + arangeW[None, :]
        in_r = offs < q_len[:, None]
        slot = torch.clamp(q_start[:, None] + offs, 0, G - 1)
        wg = gq_gang[slot]
        wkey = g_key[wg]
        wbad = (wkey >= 0) & key_bad[torch.clamp(wkey, min=0)]
        skippable = in_r & ((g_state[wg] != 0) | wbad)
        nskip = torch.cumprod(skippable.to(torch.int64), dim=1).sum(1)
        q_head = q_head + nskip
        advanced = bool((nskip > 0).any())

        # --- per-queue candidate: the head entry, if visible ---------------
        pos = torch.clamp(nskip, max=W - 1)
        head_visible = (nskip < W) & in_r[qidx, pos]
        cand = torch.where(head_visible, wg[qidx, pos], torch.zeros_like(pos))
        cand_new = g_run_t[cand] < 0
        has = head_visible & ~(cand_new & (new_blocked | q_killed)) & (p.q_weight > 0)

        # --- queue order: min proposed DRF cost, or max bid ----------------
        proposed = weighted_drf_cost(
            (q_alloc + p.q_penalty) + g_req_tot[cand], p.total_pool, p.drf_mult,
            p.q_weight,
        )
        any_q = bool(has.any())
        if prefer_large:
            # within budget: the CURRENT cost; over budget: _PL_OVER + the
            # proposed cost (f32: absorbs any cost below ~1e22, so over-budget
            # queues tie there); exact ties to the largest gang, then the
            # lowest queue
            current = weighted_drf_cost(q_alloc + p.q_penalty, p.total_pool, p.drf_mult,
                                        p.q_weight)
            order_key = torch.where(proposed <= q_budget, current, _PL_OVER + proposed)
            if market:
                order_key = -p.g_price[cand]
            order_key = torch.where(has, order_key, torch.full_like(order_key, _INF))
            tied = has & (order_key == order_key.min())
            tie_size = torch.where(tied, g_size[cand], torch.full_like(order_key, -_INF))
            pick = tied & (tie_size >= tie_size.max())
            qstar = int(torch.where(pick, qidx, torch.full_like(qidx, Q - 1)).min())
        else:
            order_key = -p.g_price[cand] if market else proposed
            order_key = torch.where(has, order_key, torch.full_like(order_key, _INF))
            qstar = int(torch.argmin(order_key))

        g = int(cand[qstar])
        req = p.g_req[g]
        card = int(host["g_card"][g])
        level = int(host["g_level"][g])
        key = int(host["g_key"][g])
        pc = int(host["g_pc"][g])
        run = int(host["g_run"][g])
        is_evictee = run >= 0
        run_safe = run if is_evictee else RJ - 1
        pinned = int(host["run_node"][run_safe]) if is_evictee else -1
        req_tot = req * float(card)
        req_node = g_req_node[g]
        req_float_tot = g_float_tot[g]

        # --- constraint gates ------------------------------------------------
        if is_evictee:
            hit_burst = hit_round_cap = hit_q_burst = hit_q_cap = False
        else:
            hit_burst = sched_count + card > global_burst
            hit_round_cap = bool(((sched_res + req_tot) > p.round_cap).any())
            hit_q_burst = int(q_sched[qstar]) + card > int(host["perq_burst"][qstar])
            hit_q_cap = bool(((q_alloc_pc[qstar, pc] + req_tot) > p.pc_queue_cap[pc]).any())
        gate_global = (hit_burst or hit_round_cap) and any_q
        gate_queue = (hit_q_burst or hit_q_cap) and not gate_global and any_q
        attempt = any_q and not gate_global and not gate_queue

        # --- fit + node selection ------------------------------------------
        float_ok = is_evictee or bool(((float_used + req_float_tot) <= float_cap).all())
        if is_evictee:
            pin_safe = min(max(pinned, 0), N - 1)
            fits = bool(_fit_row(alloc[level, pin_safe], req_node)) and bool(p.node_ok[pin_safe])
            nodes_w = empty_nodes.clone()
            counts_w = empty_counts.clone()
            nodes_w[0] = pinned if fits else N
            counts_w[0] = int(fits)
            fit_feasible = fits
        elif cache is not None and card == 1 and key >= 0 and int(host["g_ban_row"][g]) == 0 \
                and not (hetero and int(host["key_type_row"][key]) != 0):
            # a cacheable single: unbanned, keyed and (TR > 1) type-insensitive,
            # since the cached scores carry no bias
            node, found = cache.pick(alloc, key, level, req_node, p.compat[key][node_type])
            nodes_w = empty_nodes.clone()
            counts_w = empty_counts.clone()
            nodes_w[0] = node if found else N
            counts_w[0] = int(found)
            fit_feasible = found
        else:
            if key >= 0:
                static_ok = p.compat[key][node_type]
            else:
                static_ok = torch.ones((N,), dtype=torch.bool, device=dev)
            banned = p.ban_mask[int(host["g_ban_row"][g])]
            ok_base = static_ok & p.node_ok & ~banned
            zero_cap = torch.zeros((N,), dtype=i32, device=dev)
            cap_clean = torch.where(
                ok_base, torch.clamp(member_capacity(alloc[0], req_node), max=card), zero_cap
            )
            use_clean = int(cap_clean.sum()) >= card
            if use_clean:
                cap_sel, alloc_sel = cap_clean, alloc[0]
            else:
                cap_sel = torch.where(
                    ok_base, torch.clamp(member_capacity(alloc[level], req_node), max=card),
                    zero_cap,
                )
                alloc_sel = alloc[level]
            score = node_packing_score(alloc_sel, p.inv_scale)
            if hetero:
                # one f32 add after the packing-score chain, as in the reference
                trow = int(host["key_type_row"][key]) if key >= 0 else 0
                score = score + type_bias_nodes[trow]
            fit_feasible = int(cap_sel.sum()) >= card
            if card == 1:
                found, node = select_best_node(cap_sel >= 1, score)
                nodes_w = empty_nodes.clone()
                counts_w = empty_counts.clone()
                nodes_w[0] = int(node) if bool(found) else N
                counts_w[0] = int(bool(found))
            else:
                _, nodes_w, counts_w = select_gang_nodes_compact(
                    cap_sel >= 1, cap_sel, card, score, slot_width
                )
        feasible = fit_feasible and float_ok
        placed = attempt and feasible

        # --- commit ------------------------------------------------------------
        if placed:
            lmask = _level_mask(num_levels, level, 1 if is_evictee else 0, dev)
            sub = counts_w[:, None].to(f32) * req_node[None, :]
            live = nodes_w < N
            if bool(live.any()):
                idx = nodes_w[live].long()
                alloc[:, idx, :] -= lmask[:, None, None] * sub[live][None, :, :]
            q_alloc[qstar] += req_tot
            q_alloc_pc[qstar, pc] += req_tot
            spot_res = spot_res + req_tot
            if not is_evictee:
                sched_count += card
                sched_res = sched_res + req_tot
                float_used = float_used + req_float_tot
                q_sched[qstar] += card
            else:
                run_rescheduled[run_safe] = True
            if market and bool(spot_price < 0):
                sched_share = (
                    torch.where(p.total_pool > 0, spot_res / pool_safe, torch.zeros_like(spot_res))
                    * p.drf_mult
                ).amax()
                if float(sched_share) > spot_cutoff:
                    spot_price = p.g_spot_price[g].clone()
            if not is_evictee:
                if cursor < max_slots:
                    slot_gang[cursor] = g
                    slot_nodes[cursor] = nodes_w
                    slot_counts[cursor] = counts_w
                cursor += 1
            g_state[g] = 1
        elif attempt:
            g_state[g] = 2
            if card == 1 and key >= 0:
                key_bad[key] = True

        if gate_queue:
            q_killed[qstar] = True
        if gate_global:
            new_blocked = True
            if termination == TERM_EXHAUSTED:
                termination = TERM_GLOBAL_BURST if hit_burst else TERM_ROUND_CAP
        done = not any_q and not advanced

        # --- the multi-commit extension: up to commit_k - 1 more placements
        n_ext = 0
        hidden = bool(((nskip >= W) & (q_head < q_len)).any())
        if commit_k > 1 and placed and not market and not hidden:
            qe, ge, node_e, n_ext = _extension(
                p, commit_k - 1, qstar=qstar, order_key=order_key, cand=cand, pos=pos,
                wg=wg, in_r=in_r, skippable=skippable, alloc=alloc, q_alloc=q_alloc,
                q_alloc_pc=q_alloc_pc, q_sched=q_sched, q_killed=q_killed,
                new_blocked=new_blocked, sched_count=sched_count, sched_res=sched_res,
                float_used=float_used, float_cap=float_cap, iterations=iterations,
                max_iterations=max_iterations, g_req_node=g_req_node,
                g_float_tot=g_float_tot, g_req_tot=g_req_tot, hetero=hetero,
            )
            # (9) the certified prefix commits in pick order
            for e in range(n_ext):
                q, gg, nd = int(qe[e]), int(ge[e]), int(node_e[e])
                lvl, pce = int(host["g_level"][gg]), int(host["g_pc"][gg])
                req_e, reqn_e = p.g_req[gg], g_req_node[gg]
                alloc[: lvl + 1, nd, :] -= reqn_e[None, :]
                q_alloc[q] += req_e
                q_alloc_pc[q, pce] += req_e
                q_sched[q] += 1
                sched_res = sched_res + req_e
                float_used = float_used + g_float_tot[gg]
                spot_res = spot_res + req_e
                g_state[gg] = 1
                if cursor < max_slots:
                    slot_gang[cursor] = gg
                    slot_nodes[cursor] = empty_nodes
                    slot_nodes[cursor, 0] = nd
                    slot_counts[cursor] = empty_counts
                    slot_counts[cursor, 0] = 1
                cursor += 1
            sched_count += n_ext

        # --- the fit cache's upkeep at every node this step's commits touched
        if cache is not None and placed:
            touched = nodes_w[nodes_w < N].long()
            if n_ext:
                touched = torch.cat([touched, node_e[:n_ext].long()])
            cache.update(alloc, touched)

        # --- the certified pick chain: up to batch_k - 1 more placements ----
        if batch_k > 1 and placed:
            chain = _pick_chain(
                p, batch_k - 1, qstar=qstar, pos=pos, wg=wg, in_r=in_r, skippable=skippable,
                alloc=alloc, q_alloc=q_alloc, q_alloc_pc=q_alloc_pc, q_sched=q_sched,
                q_killed=q_killed, new_blocked=new_blocked, sched_count=sched_count,
                sched_res=sched_res, float_used=float_used, float_cap=float_cap,
                spot_res=spot_res, spot_price=spot_price, pool_safe=pool_safe,
                iterations=iterations + 1, max_iterations=max_iterations,
                g_req_node=g_req_node, g_float_tot=g_float_tot, g_req_tot=g_req_tot,
                type_bias_nodes=type_bias_nodes, host=host,
            )
            (alloc, q_alloc, q_alloc_pc, sched_count, sched_res, float_used, spot_res,
             spot_price, cursor, n_ext) = _commit_chain(
                p, chain, num_levels=num_levels, alloc=alloc, q_alloc=q_alloc,
                q_alloc_pc=q_alloc_pc, q_sched=q_sched, sched_count=sched_count,
                sched_res=sched_res, float_used=float_used, g_state=g_state,
                run_rescheduled=run_rescheduled, slot_gang=slot_gang, slot_nodes=slot_nodes,
                slot_counts=slot_counts, cursor=cursor, max_slots=max_slots,
            )
        iterations += 1 + n_ext
        kernel_iters += 1

    if not done and iterations >= max_iterations:
        termination = TERM_MAX_ITER

    g_state = retire_bad_keys(g_state, p, key_bad)
    alloc, q_alloc, run_evicted, run_rescheduled = phase_b(
        p, alloc, q_alloc, run_evicted, run_rescheduled, num_levels
    )
    alloc = unbind_preempted(alloc, p, run_evicted, run_rescheduled)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    return RoundResult(
        g_state=g_state,
        slot_gang=slot_gang,
        slot_nodes=slot_nodes,
        slot_counts=slot_counts,
        n_slots=scalar(cursor, i32),
        run_evicted=run_evicted,
        run_rescheduled=run_rescheduled,
        alloc=alloc,
        q_alloc=q_alloc,
        iterations=scalar(iterations, i32),
        termination=scalar(termination, i32),
        scheduled_count=scalar(sched_count, i32),
        spot_price=spot_price,
        q_killed=q_killed,
        kernel_iters=scalar(kernel_iters, i32),
    )


def _ordered_masked_sum(mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """sum_k mask[..., k] * rows[k] (f32), added in ascending k from +0."""
    acc = torch.zeros(mask.shape[:-1] + rows.shape[1:], dtype=rows.dtype, device=rows.device)
    for k in range(int(rows.shape[0])):
        acc = acc + mask[..., k, None] * rows[k]
    return acc


def _window_tables(in_r, skippable):
    """(nn, tail_known) of the step's [Q, W] cursor window, shared by both
    extensions (fair_scheduler.py:760-772): nn[q, i] is the first parked
    (undecided) window index at or after i, W if none; tail_known[q] says
    the window reaches past the queue's tail, so nothing hides beyond it."""
    W = in_r.shape[1]
    parked = in_r & ~skippable
    nn = torch.full((in_r.shape[0], W + 1), W, dtype=torch.int64, device=in_r.device)
    for i in range(W - 1, -1, -1):
        nn[:, i] = torch.where(parked[:, i], i, nn[:, i + 1])
    return nn, ~in_r[:, W - 1]


def _extension(p: SchedulingProblem, E: int, *, qstar, order_key, cand, pos, wg, in_r,
               skippable, alloc, q_alloc, q_alloc_pc, q_sched, q_killed, new_blocked,
               sched_count, sched_res, float_used, float_cap, iterations, max_iterations,
               g_req_node, g_float_tot, g_req_tot, hetero):
    """The multi-commit extension of one placement step (the JAX package's
    `_make_place_iteration` at commit_k = E + 1), run after the head queue
    placed its gang in a non-market round with no queue's window exhausted.
    Every argument is the step's state after the head's commit.  Returns
    (qe, ge, node_e, n): the E next queues in order-key order, their head
    gangs, each one's node, and the length of the certified prefix -- the
    picks that provably equal the next n sequential steps: non-evictee,
    unbanned, type-insensitive singles within every cap, whose queues'
    next candidates do not precede a later pick, and whose nodes neither
    flip another pick's clean fit nor beat its best fit."""
    dev = order_key.device
    N = p.node_total.shape[0]
    W = SKIP_WINDOW
    f32 = torch.float32
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    iota_e = torch.arange(E, device=dev)
    iota_k = torch.arange(E + 1, device=dev)

    # (1) the E + 1 lowest order keys, ties to the lower queue (a stable
    # sort; rank 0 is the head queue)
    topq = torch.sort(order_key, stable=True).indices[: E + 1]
    qe = topq[1:]
    keye = order_key[qe]
    ge = cand[qe].long()
    card_e = p.g_card[ge]
    run_e = p.g_run[ge]
    level_e = p.g_level[ge].long()
    key_e = p.g_key[ge].long()
    pc_e = p.g_pc[ge].long()
    req_e = p.g_req[ge]
    reqn_e = g_req_node[ge]
    flt_e = g_float_tot[ge]

    # (3) eligibility: unbanned, non-evictee singles with a live key;
    # type-sensitive picks run as heads (their bias can flip node choices)
    elig = (keye < inf) & (card_e == 1) & (run_e < 0) & (p.g_ban_row[ge] == 0)
    if hetero:
        trow_e = torch.where(key_e >= 0, p.key_type_row[key_e.clamp(min=0)], 0)
        elig &= trow_e == 0

    # (4) caps, burst, floating capacity and the iteration bound, walked in
    # commit order with the sequential f32 accumulation
    ok_caps = torch.zeros((E,), dtype=torch.bool, device=dev)
    run_res, run_flt = sched_res, float_used
    for i in range(E):
        run_res = run_res + req_e[i]
        run_flt = run_flt + flt_e[i]
        ok_caps[i] = (
            (sched_count + i + 1 <= int(p.global_burst))
            and bool((run_res <= p.round_cap).all())
            and bool((run_flt <= float_cap).all())
            and iterations + 1 + i < max_iterations
        )
    ok_caps &= (q_sched[qe] + 1) <= p.perq_burst[qe]
    ok_caps &= ((q_alloc_pc[qe, pc_e] + req_e) <= p.pc_queue_cap[pc_e]).all(dim=1)

    # (5) queue order: after each batch queue commits, its NEXT candidate
    # (the first undecided window entry past its head) must not precede a
    # later pick; a window that ends before the queue's tail proves nothing
    qk = torch.cat([torch.tensor([qstar], device=dev), qe])
    nn, tail_known = _window_tables(in_r, skippable)
    npos = nn[qk, torch.clamp(pos[qk] + 1, max=W)]
    g_next = wg[qk, torch.clamp(npos, max=W - 1)]
    own_req = torch.cat([torch.zeros((1, req_e.shape[1]), dtype=f32, device=dev), req_e])
    row_k = q_alloc[qk] + own_req
    nk = weighted_drf_cost((row_k + p.q_penalty[qk]) + g_req_tot[g_next], p.total_pool,
                           p.drf_mult, p.q_weight[qk])
    next_new = p.g_run[g_next] < 0
    allowed = ~(next_new & (new_blocked | q_killed[qk])) & (p.q_weight[qk] > 0)
    nk = torch.where(allowed, nk, inf)
    nk = torch.where(npos < W, nk, torch.where(tail_known[qk], inf, -inf))
    prior_k = iota_k[:, None] <= iota_e[None, :]
    ok_pair = (nk[:, None] > keye[None, :]) | (
        (nk[:, None] == keye[None, :]) & (qk[:, None] > qe[None, :])
    )
    ok_order = (ok_pair | ~prior_k).all(dim=0)

    # (6) each pick's node against the post-head state: the masked-score
    # first argmin at the clean level, else at the pick's own level
    node_type = p.node_type.long()
    static_e = torch.where((key_e >= 0)[:, None], p.compat[key_e.clamp(min=0)][:, node_type],
                           torch.ones((E, N), dtype=torch.bool, device=dev))
    okn_e = static_e & p.node_ok[None, :]
    fit0_e = okn_e & _fit_row(alloc[0][None, :, :], reqn_e[:, None, :])
    fitl_e = okn_e & _fit_row(alloc[level_e], reqn_e[:, None, :])
    score_lvls = node_packing_score(alloc, p.inv_scale)
    use_clean_e = fit0_e.any(dim=1)
    msel = torch.where(
        use_clean_e[:, None],
        torch.where(fit0_e, score_lvls[0][None, :], inf),
        torch.where(fitl_e, score_lvls[level_e], inf),
    )
    node_e = torch.argmin(msel, dim=1)
    found_e = msel[iota_e, node_e] < inf
    lvl_sel_e = torch.where(use_clean_e, 0, level_e)

    # (7) conflicts under the cumulative deltas of the earlier picks: no
    # clean-fit flip at an earlier pick's node, the pick's own node still
    # fits, and no earlier pick's node now beats it (lower score, or equal
    # at a lower index)
    prior_f = (iota_e[:, None] > iota_e[None, :]).to(f32)  # [e, k]: k before e
    samen = (node_e[:, None] == node_e[None, :]).to(f32)  # [j, k]: same node
    cum0 = _ordered_masked_sum(prior_f[:, None, :] * samen[None, :, :], reqn_e)
    okn_at = okn_e[:, node_e]  # [e, j]
    post_fit0 = okn_at & _fit_row(alloc[0][node_e][None, :, :] - cum0, reqn_e[:, None, :])
    flip0 = fit0_e[:, node_e] & ~post_fit0
    applies = prior_f * (lvl_sel_e[:, None] <= level_e[None, :]).to(f32)
    cum_sel = _ordered_masked_sum(applies[:, None, :] * samen[None, :, :], reqn_e)
    adj_sel = alloc[lvl_sel_e][:, node_e] - cum_sel
    adj_fit = okn_at & _fit_row(adj_sel, reqn_e[:, None, :])
    adj_score = node_packing_score(adj_sel, p.inv_scale)
    self_fit = adj_fit[iota_e, iota_e]
    self_score = adj_score[iota_e, iota_e]
    beats = adj_fit & (
        (adj_score < self_score[:, None])
        | ((adj_score == self_score[:, None]) & (node_e[None, :] < node_e[:, None]))
    )
    self_pair = node_e[:, None] == node_e[None, :]
    prior_e = iota_e[None, :] < iota_e[:, None]
    conflict = torch.where(self_pair, flip0, flip0 | beats)
    ok_nodes = self_fit & ~(conflict & prior_e).any(dim=1)

    # (8) the certified prefix
    raw_ok = elig & ok_caps & ok_order & ok_nodes & found_e
    n = int(torch.cumprod(raw_ok.to(torch.int64), dim=0).sum())
    return qe, ge, node_e, n


def block_size(n: int) -> int:
    """Largest power-of-two block size <= 64 dividing n: the fit cache's
    block-minima rows tile the node axis exactly."""
    for b in (64, 32, 16, 8, 4, 2):
        if n % b == 0:
            return b
    return 1


class _FitCache:
    """The per-key fit cache of the JAX package's cached body (cache_slots
    > 0; fair_scheduler.py:515-600, the setup at :1930-1945 and the upkeep
    at :1017-1079).  Slot s = key % S holds one (key, level, request)'s fit
    rows at the clean level and at its own level, and their block minima:
    the least masked packing score in each block of B nodes.  One
    packing-score row per level serves every slot.

    A hit (key, level and request all equal; a colliding key misses) picks
    the first block attaining the least block minimum, then the first node
    attaining it inside that block -- the first argmin over every node, as
    the uncached pass takes it, from NB + B elements instead of N.  A miss
    computes the rows in one pass over the nodes and takes the slot.  After
    each commit the scores at the touched nodes, every slot's fit bits
    there and the touched blocks' minima are re-derived from the new
    allocatable, so every row stays what a fresh pass would give: the cache
    memoises exactly and changes no decision.  The scores are the packing
    score's fma chain, as XLA:CPU computes the JAX package's tables (the
    same left-to-right chain as the uncached score; ROADMAP Queue 3)."""

    def __init__(self, p: SchedulingProblem, alloc: torch.Tensor, slots: int):
        dev = alloc.device
        P1, N, R = alloc.shape
        self.p, self.S, self.N = p, slots, N
        self.B = block_size(N)
        self.NB = N // self.B
        self.node_type = p.node_type.long()
        self.fit_clean = torch.zeros((slots, N), dtype=torch.bool, device=dev)
        self.fit_lvl = torch.zeros((slots, N), dtype=torch.bool, device=dev)
        # over the post-eviction allocatable: the loop's starting state
        self.score = node_packing_score(alloc, p.inv_scale)  # [P1, N]
        self.bm_clean = torch.full((slots, self.NB), _INF, dtype=torch.float32, device=dev)
        self.bm_lvl = torch.full((slots, self.NB), _INF, dtype=torch.float32, device=dev)
        self.key = torch.full((slots,), -1, dtype=torch.int64, device=dev)
        self.lvl = torch.zeros((slots,), dtype=torch.int64, device=dev)
        self.req = torch.zeros((slots, R), dtype=torch.float32, device=dev)

    def _pick_at(self, bm, fit, score):
        b = int(torch.argmin(bm))
        lo = b * self.B
        masked = torch.where(fit[lo:lo + self.B], score[lo:lo + self.B],
                             torch.full((self.B,), _INF, dtype=score.dtype, device=score.device))
        return lo + int(torch.argmin(masked)), float(bm[b]) < _INF

    def pick(self, alloc, key: int, level: int, req_node, static_ok):
        """(node, found) of a cacheable single, clean level first."""
        s = key % self.S
        hit = (int(self.key[s]) == key and int(self.lvl[s]) == level
               and bool((self.req[s] == req_node).all()))
        if hit:
            if float(self.bm_clean[s].min()) < _INF:
                return self._pick_at(self.bm_clean[s], self.fit_clean[s], self.score[0])
            return self._pick_at(self.bm_lvl[s], self.fit_lvl[s], self.score[level])
        ok = static_ok & self.p.node_ok
        fc = ok & _fit_row(alloc[0], req_node)
        fl = ok & _fit_row(alloc[level], req_node)
        inf = torch.full_like(self.score[0], _INF)
        m0 = torch.where(fc, self.score[0], inf)
        ml = torch.where(fl, self.score[level], inf)
        self.fit_clean[s], self.fit_lvl[s] = fc, fl
        self.bm_clean[s] = m0.reshape(self.NB, self.B).amin(dim=1)
        self.bm_lvl[s] = ml.reshape(self.NB, self.B).amin(dim=1)
        self.key[s], self.lvl[s], self.req[s] = key, level, req_node
        n0 = int(torch.argmin(m0))
        if float(m0[n0]) < _INF:
            return n0, True
        nl = int(torch.argmin(ml))
        return nl, float(ml[nl]) < _INF

    def update(self, alloc, touched):
        """Re-derive the tables at the nodes `touched` by this step's commits."""
        p, B = self.p, self.B
        tn = torch.unique(touched)
        self.score[:, tn] = node_packing_score(alloc[:, tn, :], p.inv_scale)
        ok = ((self.key >= 0)[:, None] & p.compat[self.key.clamp(min=0)][:, self.node_type[tn]]
              & p.node_ok[tn][None, :])
        req = self.req[:, None, :]
        self.fit_clean[:, tn] = ok & _fit_row(alloc[0, tn][None, :, :], req)
        self.fit_lvl[:, tn] = ok & _fit_row(alloc[self.lvl[:, None], tn[None, :]], req)
        blocks = torch.unique(tn // B)
        nblk = blocks[:, None] * B + torch.arange(B, device=tn.device)[None, :]  # [TB, B]
        inf = torch.tensor(_INF, dtype=torch.float32, device=tn.device)
        self.bm_clean[:, blocks] = torch.where(
            self.fit_clean[:, nblk], self.score[0][nblk][None], inf).amin(dim=-1)
        self.bm_lvl[:, blocks] = torch.where(
            self.fit_lvl[:, nblk], self.score[self.lvl[:, None, None], nblk[None]], inf
        ).amin(dim=-1)


class _ChainPick(NamedTuple):
    q: int
    g: int
    node: int
    lo: int  # the lowest level the pick's commit reaches (1 for an evictee)
    level: int
    pc: int
    run: int  # -1 unless an evictee
    req: torch.Tensor
    reqn: torch.Tensor
    flt: torch.Tensor


def _chain_delta(picks, node: int, lvl: int, like: torch.Tensor) -> torch.Tensor:
    """The earlier picks' requests committed at (lvl, node), summed in pick
    order from 0 (integral resolution units: exact in any order)."""
    acc = torch.zeros_like(like)
    for pk in picks:
        if pk.node == node and pk.lo <= lvl <= pk.level:
            acc = acc + pk.reqn
    return acc


def _pick_chain(p: SchedulingProblem, E: int, *, qstar, pos, wg, in_r, skippable, alloc,
                q_alloc, q_alloc_pc, q_sched, q_killed, new_blocked, sched_count, sched_res,
                float_used, float_cap, spot_res, spot_price, pool_safe, iterations,
                max_iterations, g_req_node, g_float_tot, g_req_tot, type_bias_nodes, host):
    """The certified pick chain of one placement step (the JAX package's
    `_make_place_iteration` at batch_k = E + 1, fair_scheduler.py:1081-1480),
    run after the head placed.  It replays the sequential loop's next E
    steps on [Q] state -- each queue's simulated order key and window
    position -- against the post-head state, every f32 expression in the
    sequential association, and stops at the first step it cannot prove: a
    gang head, a queue whose window ends before its tail, a gate or cap that
    would trip, a floating-capacity shortfall, a no-fit, or the iteration
    bound.  The allocatable stays the post-head one during the replay: the
    earlier picks' requests are subtracted at their nodes where a later pick
    reads them.  Returns (picks, spot_res, spot_price): the picks that
    commit, in order, and the spot state after them.  `iterations` is the
    step count after the head."""
    dev = alloc.device
    N = p.node_total.shape[0]
    Q = p.q_weight.shape[0]
    W = SKIP_WINDOW
    f32 = torch.float32
    market = bool(p.market)
    iota_q = torch.arange(Q, device=dev)
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    node_type = p.node_type.long()

    # the cursor's next stops, and the gate on the key, not the cursor
    nn, tail_known = _window_tables(in_r, skippable)
    wev = p.g_run[wg] >= 0
    wallowed = ~(~wev & (q_killed[:, None] | bool(new_blocked))) & (p.q_weight > 0)[:, None]

    # the simulation: every queue's next order key
    sim_row = q_alloc.clone()
    simpos = torch.where(iota_q == qstar, nn[iota_q, torch.clamp(pos + 1, max=W)], nn[iota_q, pos])
    sp_safe = torch.clamp(simpos, max=W - 1)
    g_at = wg[iota_q, sp_safe]
    if market:
        sim_keys = -p.g_price[g_at]
    else:
        sim_keys = weighted_drf_cost((sim_row + p.q_penalty) + g_req_tot[g_at], p.total_pool,
                                     p.drf_mult, p.q_weight)
    sim_keys = torch.where(wallowed[iota_q, sp_safe], sim_keys, inf)
    sim_keys = torch.where(simpos < W, sim_keys, torch.where(tail_known, inf, -inf))

    picks = []
    r_count, r_res, r_float = sched_count, sched_res, float_used
    r_spot_res, r_spot, r_iter = spot_res, spot_price, iterations
    score_all = None
    row_cache = None  # the one-entry within-step fit-row cache
    for _ in range(E):
        qj = int(torch.argmin(sim_keys))
        i_j = int(simpos[qj])
        if not (float(sim_keys[qj]) < _INF and i_j < W and r_iter < max_iterations):
            break
        g = int(wg[qj, i_j])
        if int(host["g_card"][g]) != 1:
            break  # gang heads run as heads
        run = int(host["g_run"][g])
        ev = run >= 0
        lvl, pc, key, ban = (int(host[f][g]) for f in ("g_level", "g_pc", "g_key", "g_ban_row"))
        req, reqn, flt = p.g_req[g], g_req_node[g], g_float_tot[g]
        if ev:
            # a pinned evictee: its run node at its own level, exactly
            node = int(host["run_node"][run])
            adj = alloc[lvl, node] - _chain_delta(picks, node, lvl, reqn)
            if not (bool(_fit_row(adj, reqn)) and bool(p.node_ok[node])):
                break
        else:
            # the gates over the committed prefix, same-queue repeats included
            prev = [pk for pk in picks if pk.q == qj and pk.run < 0]
            prev_pc = torch.zeros_like(req)
            for pk in prev:
                if pk.pc == pc:
                    prev_pc = prev_pc + pk.req
            if not (r_count + 1 <= int(p.global_burst)
                    and bool(((r_res + req) <= p.round_cap).all())
                    and int(q_sched[qj]) + len(prev) + 1 <= int(host["perq_burst"][qj])
                    and bool((((q_alloc_pc[qj, pc] + prev_pc) + req) <= p.pc_queue_cap[pc]).all())
                    and bool(((r_float + flt) <= float_cap).all())):
                break
            # the fit rows against the post-head allocatable: reused from
            # the previous pick when it had the same key, level, bans and
            # request (the allocatable does not change during the replay)
            if row_cache is not None and key >= 0 and row_cache[0] == (key, lvl, ban) \
                    and bool((row_cache[1] == reqn).all()):
                fit0, fitl, m0, ml, n0 = row_cache[2]
            else:
                if score_all is None:
                    score_all = node_packing_score(alloc, p.inv_scale)
                static = p.compat[key][node_type] if key >= 0 else \
                    torch.ones((N,), dtype=torch.bool, device=dev)
                okn = static & p.node_ok & ~p.ban_mask[ban]
                fit0 = okn & _fit_row(alloc[0], reqn)
                fitl = okn & _fit_row(alloc[lvl], reqn)
                s0, sl = score_all[0], score_all[lvl]
                if type_bias_nodes is not None:
                    tb = type_bias_nodes[int(host["key_type_row"][key]) if key >= 0 else 0]
                    s0, sl = s0 + tb, sl + tb
                m0 = torch.where(fit0, s0, inf)
                ml = torch.where(fitl, sl, inf)
                n0 = int(fit0.sum())
            row_cache = ((key, lvl, ban), reqn, (fit0, fitl, m0, ml, n0))
            # the clean count after the earlier picks (fits only flip
            # True -> False; each touched node counted once)
            touched = list(dict.fromkeys(pk.node for pk in picks))
            flips = sum(
                1 for nd in touched
                if bool(fit0[nd]) and not bool(_fit_row(alloc[0, nd] - _chain_delta(picks, nd, 0, reqn),
                                                        reqn))
            )
            use_clean = n0 - flips >= 1
            lvl_sel = 0 if use_clean else lvl
            msel = (m0 if use_clean else ml).clone()
            fsel = fit0 if use_clean else fitl
            if touched:
                msel[torch.tensor(touched, device=dev)] = _INF
            u_node = int(torch.argmin(msel))
            u_score = float(msel[u_node])
            # the touched nodes at their adjusted allocatable
            best = (u_score, u_node)
            for pk in picks:
                nd = pk.node
                adj = alloc[lvl_sel, nd] - _chain_delta(picks, nd, lvl_sel, reqn)
                if not (bool(_fit_row(adj, reqn)) and bool(fsel[nd])):
                    continue
                sc = node_packing_score(adj, p.inv_scale)
                if type_bias_nodes is not None:
                    sc = sc + tb[nd]
                best = min(best, (float(sc), nd))
            if not best[0] < _INF:
                break  # a no-fit fails sequentially: the head path takes it
            node = best[1]
        picks.append(_ChainPick(qj, g, node, 1 if ev else 0, lvl, pc, run if ev else -1,
                                req, reqn, flt))
        if not ev:
            r_count += 1
            r_res = r_res + req
            r_float = r_float + flt
        r_spot_res = r_spot_res + req
        if market and float(r_spot) < 0:
            share = (torch.where(p.total_pool > 0, r_spot_res / pool_safe,
                                 torch.zeros_like(r_spot_res)) * p.drf_mult).amax()
            if float(share) > float(p.spot_cutoff):
                r_spot = p.g_spot_price[g].clone()
        r_iter += 1
        # the picked queue's next key
        npos = int(nn[qj, min(i_j + 1, W)])
        gn = int(wg[qj, min(npos, W - 1)])
        sim_row[qj] = sim_row[qj] + req
        if npos >= W:
            keyn = _INF if bool(tail_known[qj]) else -_INF
        elif not bool(wallowed[qj, min(npos, W - 1)]):
            keyn = _INF
        elif market:
            keyn = -float(p.g_price[gn])
        else:
            keyn = float(weighted_drf_cost(((sim_row[qj] + p.q_penalty[qj]) + g_req_tot[gn])[None],
                                           p.total_pool, p.drf_mult, p.q_weight[qj][None])[0])
        sim_keys[qj] = keyn
        simpos[qj] = npos
    return picks, r_spot_res, r_spot


def _commit_chain(p: SchedulingProblem, chain, *, num_levels, alloc, q_alloc, q_alloc_pc,
                  q_sched, sched_count, sched_res, float_used, g_state, run_rescheduled,
                  slot_gang, slot_nodes, slot_counts, cursor, max_slots):
    """Commit the certified chain's picks (the JAX package's vectorized
    commit, fair_scheduler.py:1424-1480): the allocatable, the queues'
    allocations and counts, states, rescheduled evictees and the slot
    records of new placements, in pick order; the round's scheduled
    resources gain the picks' sum.  Returns the updated scalars and tensors
    and the number of picks."""
    picks, spot_res, spot_price = chain
    add_res = torch.zeros_like(sched_res)
    add_flt = torch.zeros_like(float_used)
    N = p.node_total.shape[0]
    for pk in picks:
        alloc[pk.lo: min(pk.level, num_levels - 1) + 1, pk.node, :] -= pk.reqn[None, :]
        q_alloc[pk.q] += pk.req
        q_alloc_pc[pk.q, pk.pc] += pk.req
        g_state[pk.g] = 1
        if pk.run >= 0:
            run_rescheduled[pk.run] = True
            continue
        add_res = add_res + pk.req
        add_flt = add_flt + pk.flt
        q_sched[pk.q] += 1
        sched_count += 1
        if cursor < max_slots:
            slot_gang[cursor] = pk.g
            slot_nodes[cursor] = N
            slot_nodes[cursor, 0] = pk.node
            slot_counts[cursor] = 0
            slot_counts[cursor, 0] = 1
        cursor += 1
    return (alloc, q_alloc, q_alloc_pc, sched_count, sched_res + add_res, float_used + add_flt,
            spot_res, spot_price, cursor, len(picks))


def retire_bad_keys(g_state, p: SchedulingProblem, key_bad):
    """Gangs whose key was registered unfeasible but which no cursor reached
    are failed too (one O(G) sweep per round)."""
    g_key = p.g_key.long()
    hit = (g_state == 0) & p.g_valid & (g_key >= 0) & key_bad[torch.clamp(g_key, min=0)]
    return torch.where(hit, torch.full_like(g_state, 2), g_state)


def unbind_preempted(alloc, p: SchedulingProblem, run_evicted, run_rescheduled):
    """Drop the evicted markers of runs that did not come back."""
    gone = (run_evicted & ~run_rescheduled).to(torch.float32)
    alloc = alloc.clone()
    alloc[0].index_add_(0, p.run_node.long(), p.run_req * p.node_axes[None, :] * gone[:, None])
    return alloc


def phase_b(p: SchedulingProblem, alloc, q_alloc, run_evicted, run_rescheduled,
            num_levels: int, max_fixpoint_iters: int = 128):
    """Oversubscription repair plus the pinned re-scheduling fixed point."""
    RJ, R = p.run_req.shape
    N = p.node_total.shape[0]
    dev = alloc.device
    run_node = p.run_node.long()
    run_level = p.run_level.long()
    run_queue = p.run_queue.long()
    over_lvl = (alloc < 0).any(dim=-1)
    over_lvl[0] = False
    holds_slot = p.run_valid & (~run_evicted | run_rescheduled)
    evict2 = holds_slot & p.run_preemptible & (p.run_gang >= 0) & over_lvl[run_level, run_node]
    dummy_pc = torch.zeros((q_alloc.shape[0], 1, R), dtype=torch.float32, device=dev)
    p0 = p._replace(run_pc=torch.zeros_like(p.run_pc))
    alloc, q_alloc, _ = move_runs_to_evicted(
        alloc, q_alloc, dummy_pc, p0, evict2.to(torch.float32), num_levels
    )
    run_evicted = run_evicted | evict2
    run_rescheduled = run_rescheduled & ~evict2

    run_req_node = p.run_req * p.node_axes[None, :]
    ridx_all = torch.arange(RJ, device=dev)
    lv = torch.arange(num_levels, device=dev)
    lmask = ((lv[:, None] >= 1) & (lv[:, None] <= run_level[None, :])).to(torch.float32)
    pending = evict2.clone()
    progress = bool(evict2.any())
    i = 0
    while i < max_fixpoint_iters and progress:
        alloc_at = alloc[run_level, run_node]
        fits = (alloc_at >= run_req_node).all(dim=-1) & pending
        cost = weighted_drf_cost(
            q_alloc[run_queue] + p.run_req, p.total_pool, p.drf_mult, p.q_weight[run_queue]
        )
        cost = torch.where(fits, cost, torch.full_like(cost, _INF))
        nmin = torch.full((N,), _INF, dtype=torch.float32, device=dev).scatter_reduce(
            0, run_node, cost, reduce="amin", include_self=True
        )
        win = fits & (cost <= nmin[run_node])
        ridx = torch.where(win, ridx_all, torch.full_like(ridx_all, _BIGI))
        rmin = torch.full((N,), _BIGI, dtype=torch.int64, device=dev).scatter_reduce(
            0, run_node, ridx, reduce="amin", include_self=True
        )
        win = win & (ridx_all == rmin[run_node])
        winf = win.to(torch.float32)
        alloc = alloc.clone()
        alloc.index_add_(1, run_node, -(lmask[:, :, None] * (run_req_node * winf[:, None])[None]))
        q_alloc = q_alloc.clone()
        q_alloc.index_add_(0, run_queue, p.run_req * winf[:, None])
        run_rescheduled = run_rescheduled | win
        pending = pending & ~win
        progress = bool(win.any())
        i += 1
    return alloc, q_alloc, run_evicted, run_rescheduled


# --- the packed decode buffer --------------------------------------------------


def compact_len(S: int, W: int, fcap: int, ecap: int) -> int:
    return COMPACT_HEADER + S + 2 * S * W + fcap + 2 * ecap


def compact_result(result: RoundResult, num_real_gangs: int, num_real_runs: int,
                   *, fcap: int, ecap: int) -> torch.Tensor:
    """Pack the O(decisions) slice of a RoundResult into one i32 buffer.

    Layout: [n_slots, iterations, termination, sched_count, spot_price_bits,
    n_failed, n_pre, n_res, kernel_iters] ++ slot_gang[S] ++ slot_nodes[S*W]
    ++ slot_counts[S*W] ++ failed_idx[fcap] ++ pre_idx[ecap] ++ res_idx[ecap],
    index lists in ascending order and padded with -1.  A CUDA result runs
    kernel K-C; a CPU result the plain version."""
    from armada_tpu_torch.kernels.compact import compact_result as wrapper

    return wrapper(result, num_real_gangs, num_real_runs, fcap=fcap, ecap=ecap)


def _first_indices(mask: torch.Tensor, cap: int) -> torch.Tensor:
    idx = torch.nonzero(mask).flatten()[:cap].to(torch.int32)
    out = torch.full((cap,), -1, dtype=torch.int32, device=mask.device)
    out[: idx.shape[0]] = idx
    return out


def compact_result_plain(result: RoundResult, num_real_gangs: int, num_real_runs: int,
                         *, fcap: int, ecap: int) -> torch.Tensor:
    """The plain version of kernel K-C."""
    dev = result.g_state.device
    G = result.g_state.shape[0]
    RJ = result.run_evicted.shape[0]
    failed = (torch.arange(G, device=dev) < num_real_gangs) & (result.g_state == 2)
    real_r = torch.arange(RJ, device=dev) < num_real_runs
    pre = result.run_evicted & ~result.run_rescheduled & real_r
    res = result.run_evicted & result.run_rescheduled & real_r
    i32 = torch.int32
    header = torch.stack([
        result.n_slots.to(i32).reshape(()),
        result.iterations.to(i32).reshape(()),
        result.termination.to(i32).reshape(()),
        result.scheduled_count.to(i32).reshape(()),
        result.spot_price.to(torch.float32).reshape(()).view(i32),
        failed.sum().to(i32),
        pre.sum().to(i32),
        res.sum().to(i32),
        result.kernel_iters.to(i32).reshape(()),
    ])
    return torch.cat([
        header,
        result.slot_gang.to(i32),
        result.slot_nodes.reshape(-1).to(i32),
        result.slot_counts.reshape(-1).to(i32),
        _first_indices(failed, fcap),
        _first_indices(pre, ecap),
        _first_indices(res, ecap),
    ])
