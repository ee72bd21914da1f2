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
the kernels compute.  Only the single-commit, uncached loop body is ported
(commit_k=1, cache_slots=0, batch_k=1, unroll=1): the JAX package's other
settings of those knobs are decision-identical to it; an environment that
arms them (ARMADA_COMMIT_K, ARMADA_CACHE_SLOTS, ARMADA_BATCH_K above their
accelerator defaults) raises instead of being ignored.  prefer_large and
hetero type bias (TR > 1) are not ported yet and raise.

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


def resolve_round_statics(p: SchedulingProblem, *, max_iterations: int = 0,
                          prefer_large: bool = False, cache_slots: int = -1,
                          unroll: int = -1, batch_k: int = -1,
                          commit_k: int = -1) -> int:
    """Check the statics against the ported loop shape and return the
    iteration bound (2G + Q + 8 when max_iterations <= 0)."""
    o = 1 if p.q_weight.dim() == 2 else 0  # a stacked problem's lane axis
    if prefer_large:
        raise NotImplementedError("prefer_large ordering is not ported yet")
    if int(p.type_bias.shape[o]) > 1:
        raise NotImplementedError("hetero type bias (TR > 1) is not ported yet")
    for name, value, ok in (
        ("cache_slots", cache_slots, (-1, 0)),
        ("unroll", unroll, (-1, 1)),
        ("batch_k", batch_k, (-1, 1)),
        ("commit_k", commit_k, (-1, 1)),
    ):
        if int(value) not in ok:
            raise NotImplementedError(
                f"{name}={value} is not ported; the port runs {name}={ok[1]}"
            )
    for name, default in (("ARMADA_COMMIT_K", 1), ("ARMADA_CACHE_SLOTS", 0),
                          ("ARMADA_BATCH_K", 1)):
        env = os.environ.get(name)
        if env and _env_int(env, default) > default:
            raise NotImplementedError(
                f"{name}={env} arms a loop shape that is not ported; the port runs "
                f"{name}={default}"
            )
    G = int(p.g_req.shape[o])
    Q = int(p.q_weight.shape[o])
    return max_iterations if max_iterations > 0 else 2 * G + Q + 8


def _env_int(text: str, default: int) -> int:
    try:
        return int(text)
    except ValueError:
        return default


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
) -> RoundResult:
    """Run one scheduling round.  `p` may hold numpy arrays (it is moved to
    `device` first) or tensors, which must lie on `device`.  A CUDA device
    runs the kernels; the CPU runs the plain version."""
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
    max_iterations = resolve_round_statics(
        p, max_iterations=max_iterations, prefer_large=prefer_large,
        cache_slots=cache_slots, unroll=unroll, batch_k=batch_k, commit_k=commit_k,
    )
    from armada_tpu_torch.kernels.round import schedule_round as wrapper

    return wrapper(
        p, num_levels=num_levels, max_slots=max_slots, slot_width=slot_width,
        max_iterations=max_iterations,
    )


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
    resolve as for `schedule_round`, from the per-lane shapes.  A CUDA
    problem runs kernel K-D; a CPU problem the plain version."""
    if p.q_weight.dim() != 2 or int(p.g_req.shape[0]) < 1:
        raise ValueError("schedule_round_stacked: expected a [P, ...] stacked problem")
    max_iterations = resolve_round_statics(
        p, max_iterations=max_iterations, prefer_large=prefer_large,
        cache_slots=cache_slots, unroll=unroll, batch_k=batch_k, commit_k=commit_k,
    )
    from armada_tpu_torch.kernels.round import schedule_round_stacked as wrapper

    return wrapper(
        p, num_levels=num_levels, max_slots=max_slots, slot_width=slot_width,
        max_iterations=max_iterations,
    )


def schedule_round_stacked_plain(
    p: SchedulingProblem, *, num_levels: int, max_slots: int, slot_width: int,
    max_iterations: int,
) -> RoundResult:
    """The plain version of kernel K-D: the solo plain round on each lane,
    stacked.  Exact because the lanes share nothing."""
    lanes = [
        schedule_round_plain(
            SchedulingProblem(*(t[i] for t in p)), num_levels=num_levels,
            max_slots=max_slots, slot_width=slot_width, max_iterations=max_iterations,
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


def round_prologue(p: SchedulingProblem, num_levels: int):
    """Running usage, fair-share eviction and gang activation.  Returns
    (alloc, q_alloc, q_alloc_pc, float_used, run_evicted, g_state)."""
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
    max_iterations: int,
) -> RoundResult:
    """The round as plain PyTorch on the problem's device: one Python
    iteration per step of the reference's placement `while_loop`, with the
    loop body's data-dependent branches taken on host-side scalars."""
    dev = p.g_req.device
    G = p.g_req.shape[0]
    N, R = p.node_total.shape
    Q = p.q_weight.shape[0]
    RJ = p.run_req.shape[0]
    W = SKIP_WINDOW
    f32 = torch.float32
    i32 = torch.int32

    alloc, q_alloc, q_alloc_pc, float_used, run_evicted, g_state = round_prologue(
        p, num_levels
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
    host = {
        name: getattr(p, name).cpu().numpy()
        for name in ("g_card", "g_level", "g_key", "g_pc", "g_run", "g_ban_row",
                     "run_node", "perq_burst")
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
    done = False
    termination = TERM_EXHAUSTED
    spot_price = torch.tensor(-1.0, dtype=f32, device=dev)
    empty_nodes = torch.full((slot_width,), N, dtype=i32, device=dev)
    empty_counts = torch.zeros((slot_width,), dtype=i32, device=dev)

    while not done and iterations < max_iterations:
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
        order_key = -p.g_price[cand] if market else proposed
        order_key = torch.where(has, order_key, torch.full_like(order_key, _INF))
        qstar = int(torch.argmin(order_key))
        any_q = bool(has.any())

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
        iterations += 1

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
        kernel_iters=scalar(iterations, i32),
    )


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
