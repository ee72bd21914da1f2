"""Round-output verification: catch a silently wrong device result before
decode commits it.

The third small pass over the round-final state (after the round and the
compact decode): one i32[16] buffer, one extra device-to-host copy,
dispatched behind the compact buffer and checked between the compact fetch
and the host decode.  It certifies the round two independent ways:

* *Conservation invariants*, each a cross-check between two encodings of
  the same decision set the round keeps separately:

    slot-count      sum of live slot member counts == header sched_count
    gang-count      sum of placed queue-gang cardinalities == sched_count
    slot-state      per-gang slot occurrences match g_state == 1 exactly
    gang-card       every live slot's member count == its gang's g_card
    lane            live placement lanes target in-range, node_ok nodes
    node-capacity   clean-level allocatable == node_total - retained run
                    usage - new placements (per node, per resource)
    queue-alloc     q_alloc == retained run usage + placed gang requests
                    (per queue, per resource)
    evictee         run_rescheduled implies run_evicted

  A retained run is ``valid & (~evicted | rescheduled)``.  The two alloc
  checks re-derive the round's f32 accumulators with scatter-adds over the
  final masks.  Every term is integral in resolution units, so the sums are
  exact in any order while they stay below 2^24 (chip_smoke.py checks that
  bound at the reference scale); the tolerances are pure headroom.  Each
  tolerance is one fused multiply-add, as XLA:CPU evaluates the JAX
  package's jitted `0.5 + 1e-3 * node_total` (tests/test_torch_verify.py
  pins the threshold bit).

* A *fingerprint* (XOR and wrapping int32 sum) of the compact result
  buffer, folded on the device over the exact buffer the decode copies.
  Decode stashes the bytes it actually received (HostContext.last_compact_np)
  and ``verdict_of`` re-derives the folds from them, so a truncated or
  corrupted copy is caught independently of the invariants.

Any violation raises ``RoundVerificationError``.  The port has no failover
rung yet, so the error propagates out of run_round_on_device: nothing is
re-run quietly.

Arming: ``ARMADA_VERIFY`` (1/0) wins, else the latest armed plane default
(arm_default / disarm_default tokens), else the library default (off).
There is no cadence: a correctness gate that skips rounds is not a gate.

Replaces the JAX package's armada_tpu/models/verify.py; the invariant pass
is kernel K-I (csrc/verify.cu) on a card and ``verify_kernel_plain`` on the
CPU.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from armada_tpu_torch.ops.fairness import fma
from armada_tpu_torch.ops.scatter import add_drop

_VERSION = 1
_VHEADER = 16  # i32 slots; layout below (append, never reorder)
_H_VERSION = 0
_H_FLAGS = 1
_H_FP_XOR = 2
_H_FP_SUM = 3
_H_N_SLOTS = 4
_H_SLOT_MEMBERS = 5
_H_SCHED_COUNT = 6
_H_PLACED_GANGS = 7
_H_PLACED_MEMBERS = 8
_H_NODE_DIFF_BITS = 9
_H_QUEUE_DIFF_BITS = 10
_H_COMPACT_LEN = 11
_H_N_EVICTED = 12
_H_N_RESCHEDULED = 13
_QNAN_BITS = 0x7FC00000  # a NaN maximum's bits in the buffer

# Invariant bit order is part of the wire layout and the metrics `site`
# vocabulary: append, never reorder.  The two host-side sites follow.
CHECK_NAMES = (
    "slot-count",
    "gang-count",
    "slot-state",
    "gang-card",
    "lane",
    "node-capacity",
    "queue-alloc",
    "evictee",
)
SITE_FINGERPRINT = "fingerprint"
SITE_BUFFER = "buffer"
ALL_SITES = CHECK_NAMES + (SITE_FINGERPRINT, SITE_BUFFER)


class RoundVerificationError(RuntimeError):
    """A scheduling round failed output verification: a conservation
    invariant was violated on the device, or the fetched compact buffer's
    fingerprint did not match the device-computed one.  Carries the failed
    site names."""

    def __init__(self, sites, detail: str = ""):
        self.sites = tuple(sites)
        msg = f"round verification failed: {', '.join(self.sites)}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


# ---------------------------------------------------------------- arming ----


def verify_enabled() -> bool:
    """Round verification armed?  ``ARMADA_VERIFY`` wins (1/0), else the
    most recently armed plane default, else the library default (off).  A
    malformed env value falls back to the armed default."""
    env = os.environ.get("ARMADA_VERIFY")
    if env is not None:
        try:
            return int(env) != 0
        except ValueError:
            pass
    if _ARMED:
        return bool(next(reversed(_ARMED.values())))
    return _DEFAULT


_DEFAULT = False
_ARMED: dict = {}  # token -> enabled, insertion-ordered (latest wins)
_next_token = itertools.count(1)


def set_default(enabled: bool) -> bool:
    """Process library default; returns the previous value."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = bool(enabled)
    return prev


def arm_default(enabled: bool = True) -> int:
    token = next(_next_token)
    _ARMED[token] = bool(enabled)
    return token


def disarm_default(token: int) -> None:
    _ARMED.pop(token, None)


# ----------------------------------------------------------------- state ----


class VerifyState:
    """Process-global verification ledger: per-site failure counts and the
    last verdict, for health reporting."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rounds = 0
        self.failures = 0
        self.failures_by_site: dict = {}
        self.last_verdict: Optional[dict] = None

    def record_pass(self, pool: str = "") -> None:
        with self._lock:
            self.rounds += 1
            self.last_verdict = {"ok": True, "pool": pool, "ts": time.time()}

    def record_failure(self, sites, pool: str = "", detail: str = "") -> None:
        with self._lock:
            self.rounds += 1
            self.failures += 1
            for s in sites:
                self.failures_by_site[s] = self.failures_by_site.get(s, 0) + 1
            self.last_verdict = {
                "ok": False,
                "pool": pool,
                "sites": list(sites),
                "detail": detail[:300],
                "ts": time.time(),
            }

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": verify_enabled(),
                "rounds_verified": self.rounds,
                "failures": self.failures,
                "failures_by_site": dict(self.failures_by_site),
                "last_verdict": dict(self.last_verdict) if self.last_verdict else None,
            }


_STATE = VerifyState()


def verify_state() -> VerifyState:
    return _STATE


def reset_verify_state() -> VerifyState:
    """Fresh ledger (tests)."""
    global _STATE
    _STATE = VerifyState()
    return _STATE


def healthz_block() -> dict:
    """The health report's `verify` block: last verdict and failure census.
    (The JAX package adds its device quarantine scoreboard here; the port
    has no quarantine yet.)"""
    return verify_state().snapshot()


# ---------------------------------------------------------------- kernel ----


def verify_kernel_plain(
    node_total, node_ok, node_axes, run_req, run_node, run_queue, run_valid,
    g_req, g_card, g_queue, g_run, g_state, slot_gang, slot_nodes, slot_counts,
    n_slots, run_evicted, run_rescheduled, alloc0, q_alloc, scheduled_count,
    compact_buf, num_real_gangs: int,
) -> torch.Tensor:
    """The plain version of kernel K-I: the JAX package's
    `_verify_kernel_impl`, one i32[16] buffer out."""
    dev = g_state.device
    i32, f32 = torch.int32, torch.float32
    G = g_state.shape[0]
    N, R = node_total.shape
    S, W = slot_nodes.shape

    real_g = torch.arange(G, device=dev) < int(num_real_gangs)
    placed = real_g & (g_state == 1)
    placed_q = placed & (g_run < 0)

    ns = n_slots.to(i32).reshape(())
    live_slot = torch.arange(S, device=dev) < ns
    livef = live_slot.to(i32)
    mc = slot_counts.sum(dim=1, dtype=i32) * livef

    slot_members = mc.sum(dtype=i32)
    sched = scheduled_count.to(i32).reshape(())
    bad_slot_count = (
        (slot_members != sched) | (ns < 0) | (ns > S)
        | (live_slot[:, None] & (slot_counts < 0)).any()
    )
    placed_members = (g_card * placed_q.to(i32)).sum(dtype=i32)
    bad_gang_count = placed_members != sched

    occ = add_drop(torch.zeros((G,), dtype=i32, device=dev), slot_gang, livef)
    bad_slot_state = (occ != placed_q.to(i32)).any()

    sg_safe = slot_gang.long().clamp(0, G - 1)
    bad_gang_card = (live_slot & (mc != g_card[sg_safe] * livef)).any()

    lane_live = live_slot[:, None] & (slot_counts > 0)
    node_in_range = (slot_nodes >= 0) & (slot_nodes < N)
    lane_ok = node_in_range & node_ok[slot_nodes.long().clamp(0, N - 1)]
    bad_lane = (lane_live & ~lane_ok).any()

    bad_evictee = (run_valid & run_rescheduled & ~run_evicted).any()

    holds = run_valid & (~run_evicted | run_rescheduled)
    run_req_node = run_req * node_axes[None, :]
    used = add_drop(torch.zeros((N, R), dtype=f32, device=dev), run_node,
                    run_req_node * holds.to(f32)[:, None])
    g_req_node = g_req * node_axes[None, :]
    lane_members = (slot_counts * lane_live).to(f32)
    lane_req = lane_members[:, :, None] * g_req_node[sg_safe][:, None, :]
    used = add_drop(used, slot_nodes.reshape(-1), lane_req.reshape(S * W, R))
    expected_free0 = node_total - used
    node_diff_e = (alloc0 - expected_free0).abs()
    node_diff = node_diff_e.max()
    tol_node = fma(torch.full_like(node_total, 1e-3), node_total, torch.full_like(node_total, 0.5))
    bad_node = (node_diff_e > tol_node).any()

    Q = q_alloc.shape[0]
    expected_q = add_drop(torch.zeros((Q, R), dtype=f32, device=dev), run_queue,
                          run_req * holds.to(f32)[:, None])
    gang_tot = g_req * (g_card.to(f32) * placed_q.to(f32))[:, None]
    expected_q = add_drop(expected_q, g_queue, gang_tot)
    queue_diff_e = (q_alloc - expected_q).abs()
    queue_diff = queue_diff_e.max()
    big = torch.maximum(expected_q.abs(), q_alloc.abs())
    tol_q = fma(torch.full_like(big, 1e-3), big, torch.ones_like(big))
    bad_queue = (queue_diff_e > tol_q).any()

    flags = torch.zeros((), dtype=i32, device=dev)
    for bit, bad in enumerate((bad_slot_count, bad_gang_count, bad_slot_state, bad_gang_card,
                               bad_lane, bad_node, bad_queue, bad_evictee)):
        flags = flags + bad.to(i32) * (1 << bit)

    # XOR fold by pairwise halving (order-free), zero-padded to even length
    x = compact_buf.to(i32)
    if x.numel() == 0:
        x = torch.zeros((1,), dtype=i32, device=dev)
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, torch.zeros((1,), dtype=i32, device=dev)])
        x = torch.bitwise_xor(x[0::2], x[1::2])
    fp_xor = x[0]
    fp_sum = compact_buf.to(torch.int64).sum().remainder(1 << 32)
    fp_sum = torch.where(fp_sum >= (1 << 31), fp_sum - (1 << 32), fp_sum).to(i32)

    def bits(v):
        # a NaN maximum as the quiet NaN XLA:CPU writes for it (0x7fc00000):
        # the payload torch's max leaves differs by device and is not kept
        v = v.to(f32).reshape(())
        return torch.where(torch.isnan(v), torch.full((), _QNAN_BITS, dtype=i32, device=dev),
                           v.view(i32))

    out = torch.zeros((_VHEADER,), dtype=i32, device=dev)
    out[_H_VERSION] = _VERSION
    out[_H_FLAGS] = flags
    out[_H_FP_XOR] = fp_xor
    out[_H_FP_SUM] = fp_sum
    out[_H_N_SLOTS] = ns
    out[_H_SLOT_MEMBERS] = slot_members
    out[_H_SCHED_COUNT] = sched
    out[_H_PLACED_GANGS] = placed_q.to(i32).sum(dtype=i32)
    out[_H_PLACED_MEMBERS] = placed_members
    out[_H_NODE_DIFF_BITS] = bits(node_diff)
    out[_H_QUEUE_DIFF_BITS] = bits(queue_diff)
    out[_H_COMPACT_LEN] = int(compact_buf.shape[0])
    out[_H_N_EVICTED] = (run_valid & run_evicted).to(i32).sum(dtype=i32)
    out[_H_N_RESCHEDULED] = (run_valid & run_rescheduled).to(i32).sum(dtype=i32)
    return out


def verify_inputs(device_problem, result, compact_buf, num_real_gangs: int) -> tuple:
    """The kernel's positional inputs, in `verify_kernel_plain`'s order."""
    p, r = device_problem, result
    return (
        p.node_total, p.node_ok, p.node_axes, p.run_req, p.run_node, p.run_queue,
        p.run_valid, p.g_req, p.g_card, p.g_queue, p.g_run, r.g_state, r.slot_gang,
        r.slot_nodes, r.slot_counts, r.n_slots, r.run_evicted, r.run_rescheduled,
        r.alloc[0], r.q_alloc, r.scheduled_count, compact_buf, int(num_real_gangs),
    )


def dispatch_verify(device_problem, result, compact_dispatched, ctx):
    """Enqueue the verification pass behind the round and the compact
    dispatch without reading it back; returns the device buffer, or None
    when there is no compact buffer to fingerprint."""
    from armada_tpu_torch.kernels.verify import verify_round

    if compact_dispatched is None:
        return None
    return verify_round(*verify_inputs(device_problem, result, compact_dispatched[0],
                                       ctx.num_real_gangs))


def dispatch_verify_stacked(device_problem, result, compact_buf, ctxs):
    """Verification for a stacked round: the stacked K-I over the P lanes of
    the stacked problem, result and [P, L] compact buffer -- one i32 [P, 16]
    buffer, one fetch for the whole stack.  Each lane's fingerprint folds
    over exactly the row its decode fetch carries.  Returns the device
    buffer; the JAX package returns None for a host-array result, and the
    port has none (a CPU stack runs the plain version), so this returns
    None only without a compact buffer.  Per-lane verdicts come from
    ``verdict_of`` on the fetched rows."""
    from armada_tpu_torch.kernels.verify import verify_round_stacked

    if compact_buf is None:
        return None
    p, r = device_problem, result
    return verify_round_stacked(
        p.node_total, p.node_ok, p.node_axes, p.run_req, p.run_node, p.run_queue,
        p.run_valid, p.g_req, p.g_card, p.g_queue, p.g_run, r.g_state, r.slot_gang,
        r.slot_nodes, r.slot_counts, r.n_slots, r.run_evicted, r.run_rescheduled, r.alloc,
        r.q_alloc, r.scheduled_count, compact_buf, [c.num_real_gangs for c in ctxs],
    )


def host_fingerprint(buf: np.ndarray) -> tuple:
    """(xor, sum) folds over a host i32 buffer, matching the device folds
    bit for bit (i32 wraparound on the sum)."""
    arr = np.ascontiguousarray(buf, dtype=np.int32)
    fp_xor = int(np.bitwise_xor.reduce(arr)) if arr.size else 0
    fp_sum = int(np.sum(arr.astype(np.int64)) & 0xFFFFFFFF)
    return fp_xor & 0xFFFFFFFF, fp_sum


def finish_verify(dispatched, ctx, pool: str = "") -> dict:
    """Blocking fetch and verdict of a dispatched verification buffer (one
    device-to-host copy, counted in TRANSFER_STATS).  Raises
    RoundVerificationError on any violation."""
    from armada_tpu_torch.models.xfer import TRANSFER_STATS

    buf = dispatched.cpu().numpy()
    TRANSFER_STATS.count_down(buf.nbytes)
    return verdict_of(buf, ctx, pool=pool)


def verdict_of(buf: np.ndarray, ctx, pool: str = "") -> dict:
    """The host-side verdict over one already-fetched i32[16] buffer."""
    state = verify_state()

    if buf.shape[0] != _VHEADER or int(buf[_H_VERSION]) != _VERSION:
        detail = f"verify buffer corrupt (len={buf.shape[0]})"
        state.record_failure([SITE_BUFFER], pool, detail)
        raise RoundVerificationError([SITE_BUFFER], detail)

    sites = []
    flags = int(buf[_H_FLAGS])
    for bit, name in enumerate(CHECK_NAMES):
        if flags & (1 << bit):
            sites.append(name)

    compact_raw = getattr(ctx, "last_compact_np", None)
    if compact_raw is not None:
        fp_xor, fp_sum = host_fingerprint(compact_raw)
        dev_xor = int(buf[_H_FP_XOR]) & 0xFFFFFFFF
        dev_sum = int(buf[_H_FP_SUM]) & 0xFFFFFFFF
        if (
            fp_xor != dev_xor
            or fp_sum != dev_sum
            or compact_raw.size != int(buf[_H_COMPACT_LEN])
        ):
            sites.append(SITE_FINGERPRINT)

    if sites:
        detail = (
            f"sched_count={int(buf[_H_SCHED_COUNT])} "
            f"slot_members={int(buf[_H_SLOT_MEMBERS])} "
            f"placed_members={int(buf[_H_PLACED_MEMBERS])} "
            f"node_diff={float(np.int32(buf[_H_NODE_DIFF_BITS]).view(np.float32)):.3f} "
            f"queue_diff={float(np.int32(buf[_H_QUEUE_DIFF_BITS]).view(np.float32)):.3f}"
        )
        state.record_failure(sites, pool, detail)
        raise RoundVerificationError(sites, detail)

    state.record_pass(pool)
    return {
        "ok": True,
        "placed_gangs": int(buf[_H_PLACED_GANGS]),
        "scheduled_count": int(buf[_H_SCHED_COUNT]),
    }
