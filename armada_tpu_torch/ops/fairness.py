"""Dominant-resource fairness: DRF costs and water-filling fair shares.

Reference semantics (the JAX package's ops/fairness.py):
- cost of an allocation = max(0, max_r(alloc_r / total_r * multiplier_r)), the
  weighted cost divides by the queue weight (zero totals and zero weights
  contribute zero).
- fair shares come from iterative water-filling that re-shares capacity the
  queues do not demand: at most 10 iterations, stopping once <= 1% of capacity
  remains unallocated.

`fair_shares` is the wrapper of the water-filling kernel: a CUDA tensor goes
to the hand-written kernel (kernels/fair_shares.py), a CPU tensor to the plain
PyTorch version below.

f32 association.  Every [Q] sum here feeds an ordering decision (the
eviction gate), so it is taken in the order XLA:CPU takes it in the JAX
reference (read from its optimized HLO and LLVM IR):
- up to 32 elements, a plain left-to-right sum;
- above 32, XLA's tree-reduction rewrite: the length n is padded up to a
  multiple of 32, the padding split as floor(pad/2) before element 0 and the
  rest after the last, and each window of 32 is summed left to right over
  its real elements; the window sums are summed the same way, recursively.
- The loop's sum of spare shares is the one LLVM vectorizes, and only at
  25..32 elements: the first n//8 groups of 8 are accumulated lane by lane
  (lane i takes x[i], x[8+i], ...), the 8 lanes are halved pairwise (i with
  i+4, then i with i+2, then 0 with 1), and the remaining elements are added
  left to right.
The uncapped-share update `ucafs + take * (unallocated - spare)` is
contracted to one fused multiply-add, as XLA:CPU contracts it.  Checked bit
for bit against the JAX package's standalone `fair_shares` at every Q from 1
to 40 and at 64, 65, 96, 97, 128, 129, 256, 257, 1024, 1025, 8192 and 8193,
and against its round (where the call is inlined) at multiples of 32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_WINDOW = 32


def _l2r(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(int(x.shape[0])):
        acc = acc + x[i]
    return acc


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a 1-D f32 tensor in XLA:CPU's association (see module doc)."""
    n = int(x.shape[0])
    if n <= _WINDOW:
        return _l2r(x)
    k = -(-n // _WINDOW)
    lo = (k * _WINDOW - n) // 2
    padded = torch.zeros((k * _WINDOW,), dtype=x.dtype, device=x.device)
    padded[lo:lo + n] = x
    rows = padded.reshape(k, _WINDOW)
    # padding adds +0.0 to a sum that starts at +0.0: the same as skipping it
    acc = torch.zeros((k,), dtype=x.dtype, device=x.device)
    for j in range(_WINDOW):
        acc = acc + rows[:, j]
    return ordered_sum(acc)


def spare_sum(x: torch.Tensor) -> torch.Tensor:
    """The loop's sum of spare shares: ordered_sum, except at 25..32
    elements, where XLA:CPU's loop is vectorized into 8 lanes (module doc)."""
    n = int(x.shape[0])
    if not 25 <= n <= _WINDOW:
        return ordered_sum(x)
    m = n // 8
    lanes = x[0:8]
    for v in range(1, m):
        lanes = lanes + x[8 * v:8 * v + 8]
    half = lanes[0:4] + lanes[4:8]
    quarter = half[0:2] + half[2:4]
    acc = quarter[0] + quarter[1]
    for i in range(8 * m, n):
        acc = acc + x[i]
    return acc


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a*b + c with one rounding (a fused multiply-add), emulated in f64:
    the product of two f32 values is exact in f64, and the f64 sum is exact
    whenever product and c together need at most 53 significant bits.  When
    they need more, f64 rounds first, and the result can differ from a true
    fma only if that rounding lands exactly on an f32 tie."""
    return (a.double() * b.double() + c.double()).float()


def unweighted_drf_cost(alloc, total, multipliers):
    """DRF cost of allocation(s) alloc[..., R] against pool totals total[R]."""
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    frac = torch.where(total > 0, alloc / safe_total, torch.zeros_like(alloc)) * multipliers
    return torch.clamp(frac.amax(dim=-1), min=0.0)


def weighted_drf_cost(alloc, total, multipliers, weight):
    """Unweighted cost divided by the queue weight (0 where weight is 0)."""
    safe_w = torch.where(weight > 0, weight, torch.ones_like(weight))
    cost = unweighted_drf_cost(alloc, total, multipliers)
    return torch.where(weight > 0, cost / safe_w, torch.zeros_like(cost))


class FairShares(NamedTuple):
    fair_share: torch.Tensor  # weight / sum-of-weights
    demand_capped_adjusted_fair_share: torch.Tensor  # share given current demand
    uncapped_adjusted_fair_share: torch.Tensor  # share if demand were infinite


def fair_shares_plain(weights: torch.Tensor, cds: torch.Tensor,
                      max_iterations: int = 10, *, stats: dict | None = None) -> FairShares:
    """Water-filling over [Q] vectors (the plain version of kernel K-A).

    Mirrors the reference's loop exactly, including its iteration-order
    subtleties: the uncapped share update uses the previous iteration's spare
    shares, and the loop ends after the uncapped update once every queue has
    achieved its demand.  `stats`, if given, receives the loop's iteration
    count ("iterations"), the achieved queues after each ("achieved") and
    the spare sums taken ("spare_sums": one an iteration that still runs)."""
    zero = torch.zeros_like(weights)
    one = torch.ones_like(weights)
    weight_sum = ordered_sum(weights)
    fair_share = torch.where(
        weight_sum > 0, weights / torch.where(weight_sum > 0, weight_sum, 1.0), zero
    )
    achieved = torch.zeros(weights.shape, dtype=torch.bool, device=weights.device)
    spare = zero.clone()
    dcafs = zero.clone()
    ucafs = zero.clone()
    unallocated = torch.ones((), dtype=weights.dtype, device=weights.device)
    running = True
    i = 0
    while i < max_iterations and bool(unallocated > 0.01) and running:
        active_w = torch.where(achieved, zero, weights)
        total_weight = ordered_sum(active_w)
        denom = total_weight + torch.where(achieved, weights, zero)
        take = torch.where(denom > 0, weights / torch.where(denom > 0, denom, one), zero)
        ucafs = fma(take, unallocated - spare, ucafs)
        running = bool(total_weight > 0.0)
        safe_tw = torch.where(total_weight > 0, total_weight, 1.0)
        add = torch.where(
            achieved | (total_weight <= 0), zero, weights / safe_tw * unallocated
        )
        dcafs = dcafs + add
        spare_new = dcafs - cds
        newly = spare_new > 0.0
        dcafs = torch.where(newly, cds, dcafs)
        spare = torch.where(newly, spare_new, zero)
        achieved = achieved | newly
        unallocated = (
            spare_sum(spare * newly.to(spare.dtype))
            if running
            else torch.zeros((), dtype=weights.dtype, device=weights.device)
        )
        i += 1
        if stats is not None:
            stats.setdefault("achieved", []).append(int(achieved.sum()))
            stats["spare_sums"] = stats.get("spare_sums", 0) + int(running)
    if stats is not None:
        stats["iterations"] = i
    return FairShares(fair_share, dcafs, ucafs)


def fair_shares(weights, constrained_demand_share, *, max_iterations: int = 10) -> FairShares:
    """Water-filling fair shares.  A CUDA tensor runs kernel K-A; a CPU tensor
    (or a numpy array) runs the plain version."""
    w = torch.as_tensor(np.asarray(weights, np.float32)) if not isinstance(
        weights, torch.Tensor) else weights.to(torch.float32)
    c = torch.as_tensor(np.asarray(constrained_demand_share, np.float32)) if not isinstance(
        constrained_demand_share, torch.Tensor) else constrained_demand_share.to(
        device=w.device, dtype=torch.float32)
    from armada_tpu_torch.kernels.fair_shares import fair_shares as wrapper

    return FairShares(*wrapper(w, c, max_iterations=max_iterations))


def theoretical_share(weights, constrained_demand_share, priority: float) -> float:
    """The demand-capped adjusted fair share a new queue with weight
    1/priority and unbounded demand would receive beside the given queues.
    Runs on the device `weights` lies on (a numpy array: the CPU), so CUDA
    tensors run kernel K-A."""
    device = weights.device if isinstance(weights, torch.Tensor) else torch.device("cpu")

    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    w = torch.cat([f32(weights), f32([1.0 / priority])])
    c = torch.cat([f32(constrained_demand_share), f32([1.0])])
    shares = fair_shares(w, c)
    return float(shares.demand_capped_adjusted_fair_share[-1])
