"""Node-fit predicates (plain PyTorch versions of the JAX package's ops/fit.py).

Static fit (taints, labels, selectors) was precomputed on the host into a
(scheduling key x node type) matrix (core/keys.py); on the device it is one
gather.  Dynamic fit compares allocatable-at-priority with the request.

Priority semantics: a job bound at priority p consumes allocatable at every
priority <= p, so allocatable at p = total - sum of usage at levels >= p.  The
round keeps per-level usage used[P, N, R] and derives allocatable by a suffix
sum over the ladder.  Capacity values are integral in resolution units, so
the suffix sum is exact in any order.
"""

from __future__ import annotations

import torch


def allocatable_from_used(total: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """allocatable[P, N, R] = total[N, R] - sum_{p' >= p} used[p']."""
    suffix = torch.flip(torch.cumsum(torch.flip(used, [0]), dim=0), [0])
    return total[None, :, :] - suffix


def static_fit(compat: torch.Tensor, key, node_type: torch.Tensor) -> torch.Tensor:
    """bool[N]: static fit of scheduling key `key` against per-node type ids."""
    return compat[key][node_type.long()]


def dynamic_fit(alloc_at_p: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """bool[N]: the request fits in allocatable-at-priority alloc_at_p[N, R]."""
    return torch.all(alloc_at_p >= req[None, :], dim=-1)


def job_fit(compat, key, node_type, alloc_at_p, req, node_ok, pinned_node) -> torch.Tensor:
    """Full per-node fit mask for one job; pinned_node >= 0 restricts fit to
    that node (the evicted-job node-id selector)."""
    mask = static_fit(compat, key, node_type) & dynamic_fit(alloc_at_p, req) & node_ok
    n = alloc_at_p.shape[0]
    pinned = int(pinned_node)
    if pinned >= 0:
        mask = mask & (torch.arange(n, device=mask.device) == pinned)
    return mask
