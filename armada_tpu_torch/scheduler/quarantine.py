"""Quarantine: stop trusting infrastructure with high failure rates.

The port's copy of the JAX package's scheduler/quarantine.py.  Two
trackers, one philosophy, different layers:

* ``NodeQuarantine`` -- the reference's "automatically removing nodes
  exhibiting high failure rates from consideration for scheduling": every
  attempted run that dies reports its node; a node accumulating
  `failure_threshold` failures within `window_s` is treated unschedulable
  for `cooldown_s`, then re-admitted.

* ``DeviceQuarantine`` -- the accelerator-side analogue, fed by round
  verification (models/verify.py): a card whose rounds keep failing the
  conservation-invariant / fingerprint certification produces silently
  wrong answers, the one failure a re-probe's healthy matmul cannot see.
  ``strikes`` verification failures within ``window_s`` quarantine the
  card: the watchdog re-probe loop and the mesh restore loop
  (core/watchdog.DeviceSupervisor.promote, parallel/serving.restore, gated
  through watchdog.set_promotion_gate) stop re-promoting it, and rounds
  stay on the CPU rung until an operator clears it (``clear()``).  There
  is no cooldown: a chip that corrupts results does not heal by waiting.
  Knobs: ``ARMADA_QUARANTINE_STRIKES`` (default 3; 0 disables),
  ``ARMADA_QUARANTINE_WINDOW_S`` (default 600).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Deque, Dict, Optional

from armada_tpu_torch.analysis.tsan import make_lock


class NodeQuarantine:
    def __init__(
        self,
        failure_threshold: int = 0,
        window_s: float = 600.0,
        cooldown_s: float = 1200.0,
    ):
        """failure_threshold 0 disables the tracker entirely."""
        self.failure_threshold = failure_threshold
        self.window_ns = int(window_s * 1e9)
        self.cooldown_ns = int(cooldown_s * 1e9)
        self._failures: Dict[str, Deque[int]] = {}
        self._quarantined_until: Dict[str, int] = {}

    @property
    def enabled(self) -> bool:
        return self.failure_threshold > 0

    def record_failure(self, node_id: str, now_ns: int) -> bool:
        """Record one run death on `node_id`; True if this trips quarantine."""
        if not self.enabled or not node_id:
            return False
        q = self._failures.setdefault(node_id, deque())
        q.append(now_ns)
        cutoff = now_ns - self.window_ns
        while q and q[0] < cutoff:
            q.popleft()
        if len(q) >= self.failure_threshold:
            self._quarantined_until[node_id] = now_ns + self.cooldown_ns
            q.clear()
            return True
        return False

    def quarantined(self, now_ns: int) -> frozenset:
        """Node ids currently quarantined (cooldown not yet lapsed)."""
        if not self._quarantined_until:
            return frozenset()
        expired = [
            nid for nid, until in self._quarantined_until.items() if until <= now_ns
        ]
        for nid in expired:
            del self._quarantined_until[nid]
            self._failures.pop(nid, None)
        return frozenset(self._quarantined_until)


class DeviceQuarantine:
    """Per-device verification-strike scoreboard (module docstring).

    Thread-safe: strikes arrive from whichever thread ran the failed round
    (the watchdog worker, the scheduler loop, a sidecar round) while the
    re-probe loops read the promotion gate concurrently."""

    def __init__(
        self,
        strikes: Optional[int] = None,
        window_s: Optional[float] = None,
    ):
        if strikes is None:
            try:
                strikes = int(os.environ.get("ARMADA_QUARANTINE_STRIKES", "3"))
            except ValueError:
                strikes = 3
        if window_s is None:
            try:
                window_s = float(
                    os.environ.get("ARMADA_QUARANTINE_WINDOW_S", "600")
                )
            except ValueError:
                window_s = 600.0
        self.strikes = max(0, strikes)  # 0 disables (strikes still counted)
        self.window_s = max(0.0, window_s)
        self._lock = make_lock("quarantine.device")
        self._strikes: Dict[str, Deque[float]] = {}
        self._strike_totals: Dict[str, int] = {}
        self._quarantined: Dict[str, dict] = {}  # device -> {ts, reason}

    def record_strikes(self, device_ids, reason: str = "") -> list:
        """One verification strike against each device of the failed
        attempt; returns the devices this call NEWLY quarantined."""
        now = time.monotonic()
        newly = []
        with self._lock:
            for dev in device_ids:
                if not dev:
                    continue
                self._strike_totals[dev] = self._strike_totals.get(dev, 0) + 1
                q = self._strikes.setdefault(dev, deque())
                q.append(now)
                cutoff = now - self.window_s
                while q and q[0] < cutoff:
                    q.popleft()
                if (
                    self.strikes > 0
                    and len(q) >= self.strikes
                    and dev not in self._quarantined
                ):
                    self._quarantined[dev] = {
                        "ts": time.time(),
                        "reason": str(reason)[:300],
                        "strikes": len(q),
                    }
                    newly.append(dev)
        return newly

    def quarantined(self) -> dict:
        """device id -> {ts, reason, strikes}; no expiry -- operator clear
        only (a chip that corrupts results does not heal by waiting)."""
        with self._lock:
            return {d: dict(v) for d, v in self._quarantined.items()}

    def clear(self, device: str = "") -> list:
        """Operator clear: forget the
        quarantine AND the strike window for `device`, or every device
        when empty.  Returns the cleared ids; the next healthy re-probe
        may then promote."""
        with self._lock:
            targets = (
                [device]
                if device
                # BOTH maps: a device mid-window (struck but not yet
                # quarantined) must also reset, or the "fresh slate" clear
                # leaves it one strike from re-quarantine.
                else list({*self._quarantined, *self._strikes})
            )
            cleared = []
            for dev in targets:
                if dev in self._quarantined or dev in self._strikes:
                    cleared.append(dev)
                self._quarantined.pop(dev, None)
                self._strikes.pop(dev, None)
            return cleared

    def promotion_blocked(self) -> Optional[str]:
        """The watchdog/mesh promotion gate (core/watchdog
        set_promotion_gate): a non-None reason while ANY device is
        quarantined -- re-promotion targets the same backend whose answers
        the verification pass rejected, so it stays down until an operator
        clears it.  Conservative by design: a healthy-matmul probe cannot
        distinguish the corrupting chip from its neighbours."""
        with self._lock:
            if not self._quarantined:
                return None
            devs = ", ".join(sorted(self._quarantined))
        return f"device(s) quarantined by round verification: {devs}"

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "strike_threshold": self.strikes,
                "window_s": self.window_s,
                "strike_totals": dict(self._strike_totals),
                "quarantined": {
                    d: dict(v) for d, v in self._quarantined.items()
                },
            }


_DEVICE_QUARANTINE: Optional[DeviceQuarantine] = None


def device_quarantine() -> DeviceQuarantine:
    """The process-global device quarantine; first use registers its
    promotion gate with the watchdog (core/watchdog.set_promotion_gate) so
    the re-probe/restore loops consult it before promoting."""
    global _DEVICE_QUARANTINE
    if _DEVICE_QUARANTINE is None:
        _DEVICE_QUARANTINE = DeviceQuarantine()
        from armada_tpu_torch.core.watchdog import set_promotion_gate

        set_promotion_gate(_DEVICE_QUARANTINE.promotion_blocked)
    return _DEVICE_QUARANTINE


def reset_device_quarantine(**kw) -> DeviceQuarantine:
    """Fresh scoreboard (tests); re-registers the promotion gate."""
    global _DEVICE_QUARANTINE
    _DEVICE_QUARANTINE = DeviceQuarantine(**kw)
    from armada_tpu_torch.core.watchdog import set_promotion_gate

    set_promotion_gate(_DEVICE_QUARANTINE.promotion_blocked)
    return _DEVICE_QUARANTINE
