"""JAX's scatter semantics in PyTorch, for the plain versions.

`x.at[idx].set(v, mode="drop")` and `.add(v, mode="drop")`: a negative
index counts from the end of the axis; an index still outside [0, n) is
dropped.  The slab apply relies on it (bucket padding carries the sentinel
G or RJ), and so do the verify and explain passes."""

from __future__ import annotations

import torch


def jax_index(idx: torch.Tensor, n: int):
    """(index as int64, in-range mask) under JAX's scatter rule."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def set_drop(t: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A copy of `t` with t.at[idx].set(rows, mode="drop") applied."""
    out = t.clone()
    i, ok = jax_index(idx, t.shape[0])
    out[i[ok]] = rows[ok]
    return out


def add_drop(out: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out.at[idx].add(src, mode="drop"), in place."""
    i, ok = jax_index(idx, out.shape[0])
    out.index_add_(0, i[ok], src[ok])
    return out
