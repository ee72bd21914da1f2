"""The explain pass: on-device unschedulable-reason attribution.

A second pass after the round over the same device-resident problem: it
attributes every unplaced job to a dominant reason per *scheduling key*
(core/keys.class_signature determines (request, PC), so K << J and the pass
is O(K x N) dense), decoded lazily on the host.

Reason codes (append, never reorder):

  ``shape-infeasible``   the key fits no node even empty.
  ``capacity-blocked``   fits an empty node, but current allocations block
                         it (attempted and failed the fit, or still pending
                         with no node able to hold it at round-final free
                         capacity).
  ``fairness-capped``    the job's queue was deactivated by a per-queue
                         burst or per-(queue, PC) cap (RoundResult.q_killed)
                         while the job was still pending.
  ``gang-partial``       a multi-member gang (or one invalidated by the
                         all-or-nothing rollback) could not place as a unit.
  ``round-terminated``   the round stopped first while round-final capacity
                         could still hold the job.
  ``type-mismatch``      would fit an empty node if its node-type whitelist
                         were ignored.

``shape-infeasible``, ``capacity-blocked``, ``gang-partial`` and
``type-mismatch`` partition the failed set (g_state == 2); all reasons can
appear for still-pending jobs (g_state == 0).

The whole result packs into one i32 buffer fetched in one device-to-host
copy, dispatched behind the compact decode and fetched after the outcome,
every ``ARMADA_EXPLAIN_INTERVAL`` rounds (0 = off, the library default;
serve arms 10).

Replaces the JAX package's armada_tpu/models/explain.py; the pass is kernel
K-J (csrc/explain.cu) on a card and ``explain_kernel_plain`` on the CPU.
f32 association: the pool-wide free-capacity sums (frag_free) follow
XLA:CPU's reduction of the JAX program -- windows of 32 nodes summed left
to right, the padding split around the axis, recursing on the window sums
(ops/fairness.ordered_sum) -- and the per-type sums (type_frag_free) its
scatter-add, left to right in node order.  At the reference scale both
pass 2^24, so the order decides the last bits; tests/test_torch_explain.py
holds both bit for bit against the JAX package.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import numpy as np
import torch

from armada_tpu_torch.ops.scatter import add_drop, jax_index

# Reason code order is part of the wire layout and the report key names:
# append, never reorder.
REASON_NONE = 0
REASON_SHAPE = 1
REASON_CAPACITY = 2
REASON_FAIRNESS = 3
REASON_GANG = 4
REASON_TERMINATED = 5
REASON_TYPE = 6
NUM_REASONS = 7
REASON_NAMES = (
    "none",
    "shape-infeasible",
    "capacity-blocked",
    "fairness-capped",
    "gang-partial",
    "round-terminated",
    "type-mismatch",
)
# The reasons that partition RoundOutcome.failed (g_state == 2).
FAILED_REASONS = (REASON_SHAPE, REASON_CAPACITY, REASON_GANG, REASON_TYPE)

# Packed-buffer caps; module-level so tests can shrink them to force the
# truncation paths.
_EXPLAIN_KCAP = 4096
_EXPLAIN_FCAP = 8192

_HEADER = 8  # [version, n_keys, n_failed_gangs, n_failed_jobs, Q, R, T, 0]
_VERSION = 2


def explain_interval() -> int:
    """Cadence in rounds; 0 disables.  ``ARMADA_EXPLAIN_INTERVAL`` wins,
    else the most recently armed plane default, else the library default
    (0).  A malformed env value falls back to the armed/process default."""
    env = os.environ.get("ARMADA_EXPLAIN_INTERVAL")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    if _ARMED:
        return next(reversed(_ARMED.values()))
    return _DEFAULT_INTERVAL


_DEFAULT_INTERVAL = 0
_ARMED: dict = {}  # token -> interval, insertion-ordered (latest wins)
_next_token = itertools.count(1)
_round_counters: dict = {}


def set_default_interval(interval: int) -> int:
    """Process library default; returns the previous value."""
    global _DEFAULT_INTERVAL
    prev = _DEFAULT_INTERVAL
    _DEFAULT_INTERVAL = max(0, int(interval))
    return prev


def arm_default(interval: int) -> int:
    """Arm a plane-scoped explain default; returns a token for
    disarm_default.  The latest armed token wins."""
    token = next(_next_token)
    _ARMED[token] = max(0, int(interval))
    return token


def disarm_default(token: int) -> None:
    _ARMED.pop(token, None)


def reset_cadence() -> None:
    """Restart the round counters so the next round of every pool is an
    explain round."""
    _round_counters.clear()


def explain_due(pool: str = "") -> bool:
    """Advance `pool`'s cadence counter; True on its explain rounds.  Called
    once per scheduling round (models.run_round_on_device).  The counter is
    per pool, so each pool is attributed every Nth round of its own."""
    interval = explain_interval()
    if interval <= 0:
        return False
    count = _round_counters.get(pool, 0)
    _round_counters[pool] = count + 1
    return count % interval == 0


def explain_len(Q: int, R: int, T: int, kcap: int, fcap: int,
                num_reasons: int = NUM_REASONS) -> int:
    return (_HEADER + 2 * num_reasons + Q * num_reasons + 3 * kcap + 2 * fcap
            + 2 * R + 2 * T * R)


def _first_indices(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """jnp.nonzero(mask, size=cap, fill_value=-1) as i32."""
    idx = torch.nonzero(mask).flatten()[:cap].to(torch.int32)
    out = torch.full((cap,), -1, dtype=torch.int32, device=mask.device)
    out[: idx.shape[0]] = idx
    return out


def ordered_column_sums(x: torch.Tensor) -> torch.Tensor:
    """Column sums of f32[N, R] in XLA:CPU's association: ordered_sum down
    each column (windows of 32 rows with the padding split, recursing)."""
    from armada_tpu_torch.ops.fairness import ordered_sum

    return torch.stack([ordered_sum(x[:, r]) for r in range(x.shape[1])])


def _max_rows(out: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """out.at[idx].max(rows, mode="drop") in place (rows [n, R] into out
    [S, R]).  By sorting, not a scatter: a max is exact in any order, and on
    a card a scatter's atomics contend when most rows share a few indices
    (a million gangs of 32 keys)."""
    i, ok = jax_index(idx, out.shape[0])
    i, rows = i[ok], rows[ok]
    if i.numel() == 0:
        return
    for r in range(out.shape[1]):
        v, o = torch.sort(rows[:, r])  # ascending, NaN last
        k, o2 = torch.sort(i[o], stable=True)  # by index; each index's values stay ascending
        last = torch.ones_like(k, dtype=torch.bool)
        last[:-1] = k[1:] != k[:-1]
        k = k[last]
        out[k, r] = torch.maximum(out[k, r], v[o2][last])


def sequential_segment_sums(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """zeros[S, R].at[seg].add(x) with the adds of each segment taken left
    to right in row order, as XLA:CPU's scatter loop does (f32, so the order
    decides the rounding).  The rows of each segment, in row order, go
    through numpy's `add.accumulate` on the host, which adds strictly left
    to right in the array's dtype: one call a segment, however long the
    chain (torch's cumsum accumulates f32 in a wider type on the CPU)."""
    dev = x.device
    S, R = num_segments, x.shape[1]
    seg_l, ok = jax_index(seg, S)
    rows = torch.nonzero(ok).flatten()
    out = np.zeros((S, R), dtype=np.float32)
    if rows.numel():
        s = seg_l[rows]
        order = torch.argsort(s, stable=True)
        xs = x[rows[order]].cpu().numpy()
        counts = torch.bincount(s, minlength=S).cpu().numpy()
        start = 0
        for si in np.flatnonzero(counts):
            end = start + int(counts[si])
            out[si] = np.add.accumulate(xs[start:end], axis=0, dtype=np.float32)[-1]
            start = end
    return torch.from_numpy(out).to(dev)


def explain_kernel_plain(
    compat, compat_pre_type, node_type, node_ok, node_total, node_axes, g_req,
    g_card, g_queue, g_key, g_run, g_valid, g_absent, g_state, alloc, q_killed,
    num_real_gangs: int, *, kcap: int, fcap: int, num_reasons: int = NUM_REASONS,
) -> torch.Tensor:
    """The plain version of kernel K-J: the JAX package's
    `_explain_kernel_impl`, one i32 buffer out (layout in `finish_explain`)."""
    dev = g_state.device
    i32, f32 = torch.int32, torch.float32
    G = g_state.shape[0]
    K = compat.shape[0]
    N, R = node_total.shape
    Q = q_killed.shape[0]
    T = compat_pre_type.shape[1]

    real = torch.arange(G, device=dev) < int(num_real_gangs)
    jobg = real & (g_run < 0) & ~g_absent
    failed = jobg & (g_state == 2)
    pending = jobg & (g_state == 0)
    keyed = g_key >= 0
    ksafe = torch.where(keyed, g_key, torch.zeros_like(g_key)).long()

    # per-key representative request: scatter-max over unplaced gangs
    rel = (failed | pending) & keyed
    req_k = torch.zeros((K, R), dtype=f32, device=dev)
    _max_rows(req_k, g_key[rel], g_req[rel])
    req_node_k = req_k * node_axes[None, :]

    free = torch.where(node_ok[:, None], torch.clamp_min(alloc[0], 0.0),
                       torch.zeros((), dtype=f32, device=dev))

    # node_type under JAX's index rules: the gathers clamp it (after a
    # negative index counts from the end), the per-type scatters drop it
    nt_gather = torch.where(node_type < 0, node_type.long() + T, node_type.long()).clamp(0, T - 1)
    fits_empty = compat[:, nt_gather] & node_ok[None, :]
    fits_empty_pre = compat_pre_type[:, nt_gather] & node_ok[None, :]
    fits_now = fits_empty
    for ri in range(R):
        size_ok = node_total[:, ri][None, :] >= req_node_k[:, ri][:, None]
        fits_empty = fits_empty & size_ok
        fits_empty_pre = fits_empty_pre & size_ok
        fits_now = fits_now & (free[:, ri][None, :] >= req_node_k[:, ri][:, None])
    shape_ok = fits_empty.any(dim=1)
    shape_ok_pre = fits_empty_pre.any(dim=1)
    now_ok = fits_now.any(dim=1)

    shape_bad_g = keyed & ~shape_ok_pre[ksafe]
    type_bad_g = keyed & ~shape_ok[ksafe]
    now_blocked_g = keyed & ~now_ok[ksafe]

    def c(v):
        return torch.full((G,), v, dtype=i32, device=dev)

    failed_reason = torch.where((g_card > 1) | ~g_valid, c(REASON_GANG), c(REASON_CAPACITY))
    pending_reason = torch.where(
        q_killed[g_queue.long()], c(REASON_FAIRNESS),
        torch.where(now_blocked_g, c(REASON_CAPACITY), c(REASON_TERMINATED)),
    )
    reason_g = torch.where(
        failed | pending,
        torch.where(shape_bad_g, c(REASON_SHAPE),
                    torch.where(type_bad_g, c(REASON_TYPE),
                                torch.where(failed, failed_reason, pending_reason))),
        c(REASON_NONE),
    )

    w = g_card * (reason_g > 0).to(i32)
    counts_failed = add_drop(torch.zeros((num_reasons,), dtype=i32, device=dev), reason_g,
                             w * failed.to(i32))
    counts_pending = add_drop(torch.zeros((num_reasons,), dtype=i32, device=dev), reason_g,
                              w * pending.to(i32))
    queue_counts = add_drop(torch.zeros((Q * num_reasons,), dtype=i32, device=dev),
                            g_queue * num_reasons + reason_g, w)

    kr = add_drop(torch.zeros((K * num_reasons,), dtype=i32, device=dev),
                  ksafe.to(i32) * num_reasons + reason_g, w * keyed.to(i32)).reshape(K, num_reasons)
    key_count = kr.sum(dim=1, dtype=i32)
    # first maximum on ties, as jnp.argmax
    key_reason = (kr == kr.max(dim=1, keepdim=True).values).to(i32).argmax(dim=1).to(i32)
    key_has = key_count > 0
    n_keys = key_has.to(i32).sum(dtype=i32)
    key_sel = _first_indices(key_has, kcap)
    key_sel_safe = key_sel.clamp_min(0).long()
    zero = torch.zeros((), dtype=i32, device=dev)
    key_reason_out = torch.where(key_sel >= 0, key_reason[key_sel_safe], zero)
    key_count_out = torch.where(key_sel >= 0, key_count[key_sel_safe], zero)

    cfailed = real & (g_state == 2)
    n_failed_gangs = cfailed.to(i32).sum(dtype=i32)
    fidx = _first_indices(cfailed, fcap)
    failed_reason_out = torch.where(fidx >= 0, reason_g[fidx.clamp_min(0).long()], zero)
    n_failed_jobs = counts_failed.sum(dtype=i32)

    frag_free = ordered_column_sums(free)
    frag_max = free.amax(dim=0)
    type_frag_free = sequential_segment_sums(free, node_type, T)
    type_frag_max = torch.zeros((T, R), dtype=f32, device=dev)
    _max_rows(type_frag_max, node_type, free)

    header = torch.stack([
        torch.tensor(_VERSION, dtype=i32, device=dev), n_keys, n_failed_gangs, n_failed_jobs,
        torch.tensor(Q, dtype=i32, device=dev), torch.tensor(R, dtype=i32, device=dev),
        torch.tensor(T, dtype=i32, device=dev), zero,
    ])
    return torch.cat([
        header, counts_failed, counts_pending, queue_counts, key_sel, key_reason_out,
        key_count_out, fidx, failed_reason_out, frag_free.view(i32), frag_max.view(i32),
        type_frag_free.reshape(-1).view(i32), type_frag_max.reshape(-1).view(i32),
    ])


def explain_inputs(device_problem, result, num_real_gangs: int) -> tuple:
    """The kernel's positional inputs, in `explain_kernel_plain`'s order."""
    p, r = device_problem, result
    return (
        p.compat, p.compat_pre_type, p.node_type, p.node_ok, p.node_total, p.node_axes,
        p.g_req, p.g_card, p.g_queue, p.g_key, p.g_run, p.g_valid, p.g_absent, r.g_state,
        r.alloc, r.q_killed, int(num_real_gangs),
    )


@dataclasses.dataclass
class ExplainOutcome:
    """Host-decoded explain pass of one scheduling round.

    Aggregates are exact (computed densely on device); the per-key table and
    the per-job pairing are capped (truncated_* flags).  ``queue_counts``
    and ``counts`` include the still-pending set's reasons -- only the
    ``failed_counts`` vector partitions ``RoundOutcome.failed``.  One
    documented skew: decode-time gang-atomicity unwinds (placed siblings
    appended to ``failed`` AFTER the device pass) are folded into
    ``failed_counts``/``counts`` as gang-partial but cannot be placed in
    ``queue_counts`` (the host fold knows their count, not their queue), so
    on the rare unwind round the per-queue histograms under-count
    gang-partial by exactly that fold."""

    counts: dict  # reason name -> job count (failed + pending combined)
    failed_counts: dict  # reason name -> jobs; partitions RoundOutcome.failed
    pending_counts: dict  # reason name -> jobs the round never attempted
    queue_counts: dict  # queue name -> {reason name: job count}
    key_reasons: list  # [{"key": int, "reason": str, "jobs": int}]
    fragmentation: dict  # resource -> {free, largest_request, index} (atoms)
    # hw type -> {resource -> {free, largest_request, index}}; {} on
    # single-type fleets (the aggregate row says the same thing).
    fragmentation_by_type: dict = dataclasses.field(default_factory=dict)
    truncated_keys: bool = False
    job_reasons_complete: bool = True
    _failed_idx: Optional[np.ndarray] = None
    _failed_reason: Optional[np.ndarray] = None
    _ctx: object = None

    def iter_job_reasons(self):
        """Lazy (job_id, reason name) pairs for the failed set -- the
        LazyJobIds discipline: a bounded consumer (the reports LRU) never
        pays a whole-backlog decode."""
        if self._failed_idx is None or self._ctx is None:
            return
        for gi, r in zip(self._failed_idx, self._failed_reason):
            r = int(r)
            if r == REASON_NONE:  # evictee slot / empty gang: not a job
                continue
            for jid in self._ctx.members_of(int(gi)):
                yield jid, REASON_NAMES[r]

    def summary(self) -> dict:
        """The JSON-ready block reports / healthz / bench share."""
        out = {
            "counts": dict(self.counts),
            "failed_counts": dict(self.failed_counts),
            "pending_counts": dict(self.pending_counts),
            "fragmentation": {
                name: dict(vals) for name, vals in self.fragmentation.items()
            },
            "keys": list(self.key_reasons),
            "truncated_keys": self.truncated_keys,
        }
        if self.fragmentation_by_type:
            out["fragmentation_by_type"] = {
                t: {name: dict(vals) for name, vals in row.items()}
                for t, row in self.fragmentation_by_type.items()
            }
        return out


def dispatch_explain(device_problem, result, ctx):
    """Enqueue the explain pass behind the round without reading it back;
    returns (device buffer, kcap, fcap)."""
    from armada_tpu_torch.kernels.explain import explain_round

    G = int(result.g_state.shape[0])
    K = int(device_problem.compat.shape[0])
    kcap = min(K, _EXPLAIN_KCAP)
    fcap = min(G, _EXPLAIN_FCAP)
    buf = explain_round(*explain_inputs(device_problem, result, ctx.num_real_gangs),
                        kcap=kcap, fcap=fcap)
    return buf, kcap, fcap


def finish_explain(dispatched, ctx, outcome=None) -> Optional[ExplainOutcome]:
    """Blocking fetch + host decode of a dispatched explain buffer (ONE
    device->host transfer, counted in TRANSFER_STATS).  When `outcome` is
    given, decode-time gang-atomicity unwinds (placed siblings appended to
    ``failed`` after the device pass ran) are folded into ``gang-partial``
    so the failed-set partition stays exact."""
    if dispatched is None:
        return None
    buf_dev, kcap, fcap = dispatched
    buf = buf_dev.cpu().numpy()
    from armada_tpu_torch.models.xfer import TRANSFER_STATS

    TRANSFER_STATS.count_down(buf.nbytes)
    version, n_keys, n_failed_gangs, n_failed_jobs, Q, R, T = (
        int(v) for v in buf[:7]
    )
    if version != _VERSION:
        return None
    off = _HEADER
    failed_vec = buf[off : off + NUM_REASONS]
    off += NUM_REASONS
    pending_vec = buf[off : off + NUM_REASONS]
    off += NUM_REASONS
    queue_counts_vec = buf[off : off + Q * NUM_REASONS].reshape(Q, NUM_REASONS)
    off += Q * NUM_REASONS
    key_id = buf[off : off + kcap]
    off += kcap
    key_reason = buf[off : off + kcap]
    off += kcap
    key_count = buf[off : off + kcap]
    off += kcap
    failed_idx = buf[off : off + fcap]
    off += fcap
    failed_reason = buf[off : off + fcap]
    off += fcap
    frag_free = buf[off : off + R].view(np.float32)
    off += R
    frag_max = buf[off : off + R].view(np.float32)
    off += R
    type_frag_free = buf[off : off + T * R].view(np.float32).reshape(T, R)
    off += T * R
    type_frag_max = buf[off : off + T * R].view(np.float32).reshape(T, R)

    failed_counts = {
        REASON_NAMES[r]: int(failed_vec[r]) for r in range(1, NUM_REASONS)
    }
    pending_counts = {
        REASON_NAMES[r]: int(pending_vec[r]) for r in range(1, NUM_REASONS)
    }
    if outcome is not None:
        # Post-decode unwinds: placed siblings of a failed sub-gang were
        # moved into `failed` on host -- they are gang-atomicity failures.
        extra = len(outcome.failed) - n_failed_jobs
        if extra > 0:
            failed_counts[REASON_NAMES[REASON_GANG]] += extra
    counts = {
        name: failed_counts[name] + pending_counts[name]
        for name in REASON_NAMES[1:]
    }

    queue_counts = {}
    for qi in range(min(Q, ctx.num_real_queues)):
        row = {
            REASON_NAMES[r]: int(queue_counts_vec[qi, r])
            for r in range(1, NUM_REASONS)
            if queue_counts_vec[qi, r]
        }
        if row:
            queue_counts[ctx.queue_names[qi]] = row

    keys = [
        {
            "key": int(k),
            "reason": REASON_NAMES[int(r)],
            "jobs": int(c),
        }
        for k, r, c in zip(key_id, key_reason, key_count)
        if k >= 0
    ]

    factory = ctx.config.resource_list_factory()

    def frag_row(free_vec, max_vec):
        row = {}
        for ri, name in enumerate(factory.names):
            if ri >= R:
                break
            free_units = float(free_vec[ri])
            max_units = float(max_vec[ri])
            res = factory.resolutions[ri]
            row[name] = {
                "free": int(round(free_units * res)),
                "largest_request": int(round(max_units * res)),
                # 1 - largest contiguous block / total free: 0 = one node
                # could absorb all free capacity, ->1 = shattered.
                "index": (
                    round(1.0 - max_units / free_units, 6)
                    if free_units > 0
                    else 0.0
                ),
            }
        return row

    fragmentation = frag_row(frag_free, frag_max)
    # Device rows beyond the real type count are bucket padding (all-zero);
    # name rows by the host-side hardware-type registry.  Single-type fleets
    # skip the split -- the aggregate row already says it.
    type_names = list(getattr(ctx, "type_names", ()) or ())
    fragmentation_by_type = {}
    if len(type_names) > 1:
        for ti, tname in enumerate(type_names):
            if ti >= T:
                break
            fragmentation_by_type[tname or "untyped"] = frag_row(
                type_frag_free[ti], type_frag_max[ti]
            )

    live = failed_idx >= 0
    out = ExplainOutcome(
        counts=counts,
        failed_counts=failed_counts,
        pending_counts=pending_counts,
        queue_counts=queue_counts,
        key_reasons=keys,
        fragmentation=fragmentation,
        fragmentation_by_type=fragmentation_by_type,
        truncated_keys=n_keys > kcap,
        job_reasons_complete=n_failed_gangs <= fcap,
        _failed_idx=failed_idx[live],
        _failed_reason=failed_reason[live],
        _ctx=ctx,
    )
    return out
