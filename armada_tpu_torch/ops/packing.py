"""Bin-packing node selection (plain PyTorch versions of the JAX package's
ops/packing.py).

Best-fit: the fullest node that still fits wins, as an argmin over a packing
score; ties break to the lowest node index.  Gang placement takes nodes in
score order, filling each to its member capacity, until the gang is covered
(all-or-nothing).

f32 association.  The packing score sum_r alloc[n, r] * inv_scale[r] feeds
the node argmin, so it is taken exactly as XLA:CPU takes it in the JAX
reference: a chain of fused multiply-adds over r from left to right,
score = fma(a3, w3, fma(a2, w2, fma(a1, w1, a0 * w0))).
"""

from __future__ import annotations

import numpy as np
import torch

from armada_tpu_torch.ops.fairness import fma

_BIG = np.float32(3.0e38)


def node_packing_score(alloc_at_p: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """f32[...]: packing score over the last (resource) axis; lower = fuller."""
    R = alloc_at_p.shape[-1]
    score = alloc_at_p[..., 0] * inv_scale[0]
    for r in range(1, R):
        score = fma(alloc_at_p[..., r], inv_scale[r].expand_as(score), score)
    return score


def select_best_node(mask: torch.Tensor, score: torch.Tensor):
    """(found, node): first argmin of score over masked nodes, -1 if none."""
    masked = torch.where(mask, score, torch.full_like(score, float(_BIG)))
    node = torch.argmin(masked).to(torch.int32)
    found = torch.any(mask)
    return found, torch.where(found, node, torch.full_like(node, -1))


def member_capacity(alloc_at_p: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """int32[N]: how many copies of req fit on each node, clipped to [0, 2^30]."""
    pos = req > 0
    safe_req = torch.where(pos, req, torch.ones_like(req))
    per_r = torch.where(
        pos[None, :], torch.floor(alloc_at_p / safe_req[None, :]),
        torch.full_like(alloc_at_p, float(_BIG)),
    )
    cap = per_r.amin(dim=-1)
    return torch.clamp(cap, 0, 2**30).to(torch.int32)


def _gang_order(mask, capacity, cardinality, score):
    cap = torch.minimum(
        torch.where(mask, capacity, torch.zeros_like(capacity)),
        torch.as_tensor(cardinality, dtype=capacity.dtype, device=capacity.device),
    )
    masked = torch.where(mask, score, torch.full_like(score, float(_BIG)))
    order = torch.argsort(masked, stable=True)
    cap_sorted = cap[order]
    before = torch.cumsum(cap_sorted, 0) - cap_sorted
    card = torch.as_tensor(cardinality, dtype=before.dtype, device=before.device)
    take_sorted = torch.minimum(torch.clamp(card - before, min=0), cap_sorted.to(before.dtype))
    feasible = cap.sum() >= card
    return cap, order, take_sorted, feasible


def select_gang_nodes(mask, capacity, cardinality, score):
    """(feasible, counts int32[N]): all-or-nothing member spread in score order."""
    cap, order, take_sorted, feasible = _gang_order(mask, capacity, cardinality, score)
    counts = torch.zeros_like(cap, dtype=torch.int64)
    counts[order] = take_sorted
    counts = torch.where(feasible, counts, torch.zeros_like(counts))
    return feasible, counts.to(torch.int32)


def select_gang_nodes_compact(mask, capacity, cardinality, score, width: int):
    """Like select_gang_nodes, but the spread as `width` (node, count) slots
    (node index N for unused slots).  The nonzero takes are a prefix of the
    score order of length <= width, so the compact form is lossless."""
    n = capacity.shape[0]
    _, order, take_sorted, feasible = _gang_order(mask, capacity, cardinality, score)
    nodes = order[:width].to(torch.int32)
    counts = take_sorted[:width].to(torch.int32)
    if nodes.shape[0] < width:
        pad = width - nodes.shape[0]
        nodes = torch.cat([nodes, torch.full((pad,), n, dtype=torch.int32, device=nodes.device)])
        counts = torch.cat([counts, torch.zeros((pad,), dtype=torch.int32, device=counts.device)])
    nodes = torch.where(counts > 0, nodes, torch.full_like(nodes, n))
    return feasible, nodes, counts
