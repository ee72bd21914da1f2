"""Wrapper of kernel K-A (csrc/fair_shares.cu): water-filling fair shares.

One launch a call; the wrapper allocates the three outputs and nothing
else (the kernel keeps its [Q] state in shared memory, and past the shared
form's width in the outputs).  The form a Q takes is `form_of(Q)`."""

from __future__ import annotations

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, placed, require_cuda, stream_handle

MAX_QUEUES = 32 * 1024
WARP_WINDOWS = 32   # csrc/fair_shares.cu: the warp form up to 32 windows of 32
SHM_WINDOWS = 264   # csrc/fair_shares.cu FS_SHM_WINDOWS
FORMS = ("warp", "shared", "global")
_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = library()
        if any(FORMS[lib.armada_fair_shares_form(q)] != form_of(q)
               for q in (1, 32, 33, 1_024, 1_025, 8_448, 8_449, MAX_QUEUES)):
            raise RuntimeError("form_of differs from csrc/fair_shares.cu")
        _LIB = lib
    return _LIB


def form_of(Q: int) -> str:
    """The kernel's form at Q queues: "warp" (a warp a lane, Q <= 1,024),
    "shared" (a block a lane, its rows in shared memory, Q <= 8,448) or
    "global" (the two shares in the outputs, up to MAX_QUEUES)."""
    k = 1 if Q <= 32 else -(-Q // 32)
    return FORMS[0 if k <= WARP_WINDOWS else 1 if k <= SHM_WINDOWS else 2]


def fair_shares_lanes_plain(weights: torch.Tensor, cds: torch.Tensor, max_iterations: int = 10):
    """The plain version over [P, Q] rows: each lane water-filled alone."""
    from armada_tpu_torch.ops.fairness import fair_shares_plain

    lanes = [fair_shares_plain(weights[i], cds[i], max_iterations) for i in range(weights.shape[0])]
    return tuple(torch.stack([lane[k] for lane in lanes]) for k in range(3))


def fair_shares(weights: torch.Tensor, cds: torch.Tensor, *, max_iterations: int = 10):
    """(fair_share, demand_capped_adjusted, uncapped_adjusted), each f32 of
    the inputs' shape: [Q], or [P, Q] for P independent lanes.  CPU tensors
    run the plain version; CUDA tensors the kernel."""
    if not weights.is_cuda:
        from armada_tpu_torch.ops.fairness import fair_shares_plain

        if weights.dim() == 2:
            return fair_shares_lanes_plain(weights, cds, max_iterations)
        return tuple(fair_shares_plain(weights, cds, max_iterations))
    dim = weights.dim()
    if (dim not in (1, 2) or weights.dtype != torch.float32 or cds.dtype != torch.float32
            or cds.shape != weights.shape or not placed((weights, cds), weights.device)):
        if dim not in (1, 2):
            raise ValueError(f"fair_shares: expected [Q] or [P, Q] weights, got "
                             f"{tuple(weights.shape)}")
        require_cuda(weights, "weights", torch.float32, dim)
        require_cuda(cds, "constrained_demand_share", torch.float32, dim)
        raise ValueError("fair_shares: weights and demand shares differ in shape or device")
    lanes = int(weights.shape[0]) if dim == 2 else 1
    Q = int(weights.shape[-1])
    if not 0 < Q <= MAX_QUEUES:
        raise ValueError(f"fair_shares: the kernel takes 1..{MAX_QUEUES} queues, got {Q}")
    if not 0 < lanes <= 65535:
        raise ValueError(f"fair_shares: the kernel takes 1..65535 lanes, got {lanes}")
    fs = torch.empty_like(weights)
    dcafs = torch.empty_like(weights)
    ucafs = torch.empty_like(weights)
    rc = _library().armada_fair_shares(
        weights.data_ptr(), cds.data_ptr(), fs.data_ptr(), dcafs.data_ptr(), ucafs.data_ptr(),
        Q, int(max_iterations), lanes, stream_handle(),
    )
    check(rc, "fair_shares kernel")
    kernels.LAUNCHES["fair_shares"] += 1
    return fs, dcafs, ucafs
