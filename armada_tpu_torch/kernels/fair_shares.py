"""Wrapper of kernel K-A (csrc/fair_shares.cu): water-filling fair shares."""

from __future__ import annotations

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, require_cuda, stream_handle

MAX_QUEUES = 32 * 1024


def fair_shares(weights: torch.Tensor, cds: torch.Tensor, *, max_iterations: int = 10):
    """(fair_share, demand_capped_adjusted, uncapped_adjusted), each f32[Q].
    CPU tensors run the plain version; CUDA tensors the kernel."""
    if not weights.is_cuda:
        from armada_tpu_torch.ops.fairness import fair_shares_plain

        return tuple(fair_shares_plain(weights, cds, max_iterations))
    require_cuda(weights, "weights", torch.float32, 1)
    require_cuda(cds, "constrained_demand_share", torch.float32, 1)
    Q = int(weights.shape[0])
    if cds.shape != weights.shape or weights.device != cds.device:
        raise ValueError("fair_shares: weights and demand shares differ in shape or device")
    if not 0 < Q <= MAX_QUEUES:
        raise ValueError(f"fair_shares: the kernel takes 1..{MAX_QUEUES} queues, got {Q}")
    fs = torch.empty_like(weights)
    dcafs = torch.empty_like(weights)
    ucafs = torch.empty_like(weights)
    scratch = torch.empty((2 * Q,), dtype=torch.float32, device=weights.device)
    achieved = torch.empty((Q,), dtype=torch.uint8, device=weights.device)
    rc = library().armada_fair_shares(
        weights.data_ptr(), cds.data_ptr(), fs.data_ptr(), dcafs.data_ptr(),
        ucafs.data_ptr(), scratch.data_ptr(), achieved.data_ptr(), Q,
        int(max_iterations), stream_handle(),
    )
    check(rc, "fair_shares kernel")
    kernels.LAUNCHES["fair_shares"] += 1
    return fs, dcafs, ucafs
