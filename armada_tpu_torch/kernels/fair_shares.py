"""Wrapper of kernel K-A (csrc/fair_shares.cu): water-filling fair shares."""

from __future__ import annotations

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, require_cuda, stream_handle

MAX_QUEUES = 32 * 1024


def fair_shares_lanes_plain(weights: torch.Tensor, cds: torch.Tensor, max_iterations: int = 10):
    """The plain version over [P, Q] rows: each lane water-filled alone."""
    from armada_tpu_torch.ops.fairness import fair_shares_plain

    lanes = [fair_shares_plain(weights[i], cds[i], max_iterations) for i in range(weights.shape[0])]
    return tuple(torch.stack([lane[k] for lane in lanes]) for k in range(3))


def fair_shares(weights: torch.Tensor, cds: torch.Tensor, *, max_iterations: int = 10):
    """(fair_share, demand_capped_adjusted, uncapped_adjusted), each f32 of
    the inputs' shape: [Q], or [P, Q] for P independent lanes (one block
    each on the card).  CPU tensors run the plain version; CUDA tensors the
    kernel."""
    if not weights.is_cuda:
        from armada_tpu_torch.ops.fairness import fair_shares_plain

        if weights.dim() == 2:
            return fair_shares_lanes_plain(weights, cds, max_iterations)
        return tuple(fair_shares_plain(weights, cds, max_iterations))
    if weights.dim() not in (1, 2):
        raise ValueError(f"fair_shares: expected [Q] or [P, Q] weights, got {tuple(weights.shape)}")
    require_cuda(weights, "weights", torch.float32, weights.dim())
    require_cuda(cds, "constrained_demand_share", torch.float32, weights.dim())
    lanes = int(weights.shape[0]) if weights.dim() == 2 else 1
    Q = int(weights.shape[-1])
    if cds.shape != weights.shape or weights.device != cds.device:
        raise ValueError("fair_shares: weights and demand shares differ in shape or device")
    if not 0 < Q <= MAX_QUEUES:
        raise ValueError(f"fair_shares: the kernel takes 1..{MAX_QUEUES} queues, got {Q}")
    if not 0 < lanes <= 65535:
        raise ValueError(f"fair_shares: the kernel takes 1..65535 lanes, got {lanes}")
    fs = torch.empty_like(weights)
    dcafs = torch.empty_like(weights)
    ucafs = torch.empty_like(weights)
    scratch = torch.empty((lanes * 2 * Q,), dtype=torch.float32, device=weights.device)
    achieved = torch.empty((lanes * Q,), dtype=torch.uint8, device=weights.device)
    rc = library().armada_fair_shares(
        weights.data_ptr(), cds.data_ptr(), fs.data_ptr(), dcafs.data_ptr(),
        ucafs.data_ptr(), scratch.data_ptr(), achieved.data_ptr(), Q,
        int(max_iterations), lanes, stream_handle(),
    )
    check(rc, "fair_shares kernel")
    kernels.LAUNCHES["fair_shares"] += 1
    return fs, dcafs, ucafs
