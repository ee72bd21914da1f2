"""Dynamic race harness: lock-order and generation discipline, ARMADA_TSAN=1.

The port's copy of the JAX package's analysis/tsan.py.  The watchdog
(core/watchdog.py) makes the scheduler multi-threaded: a worker the
watchdog abandoned can wake at any time and race the failover thread over
shadow thunks, device caches and the builders' prefetch state.  This
harness detects that class of race mechanically, the Python analog of
running the reference's Go tests under `-race`.

Two detectors, both recording (never altering behaviour):

* **Lock-order inversions.**  :func:`make_lock` returns an instrumented
  ``threading.Lock`` wrapper.  Every acquisition records edges
  ``held -> acquired`` in a process-global order graph; observing both
  ``A -> B`` and ``B -> A`` is a potential deadlock.  Disarmed, the
  wrapper costs one attribute check per acquire.

* **Generation-stale writes.**  :class:`GenerationGuard` (and the free
  function :func:`check_generation`) assert that a mutation of
  device-resident state commits under the same generation it began
  under.  ``DeviceDeltaCache.reset()`` and
  ``IncrementalBuilder.invalidate_prefetch()`` bump generations; an
  abandoned worker completing a scatter after the reset is recorded as a
  violation.  In correct code the production guards (sig/seq checks,
  ``_prefetch_gen``) make these checks unreachable: the harness turns the
  removal of one of those guards into a recorded violation.

Violations accumulate in a process-global list.  Arming: ``ARMADA_TSAN=1``
in the environment at process start, or :func:`enable` / :func:`disable`
at runtime.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Optional

# Armed state: a plain module global read on every acquire.  enable() /
# disable() flip it at runtime; the env var arms it at import (serve,
# pytest-under-ARMADA_TSAN, chaos drills).
_enabled: bool = os.environ.get("ARMADA_TSAN") == "1"

# The harness's own bookkeeping lock is a RAW threading.Lock: it must never
# appear in the order graph it maintains.
_state_lock = threading.Lock()
_held = threading.local()  # per-thread acquisition stack of lock names
_edges: dict = {}  # (first, second) -> "thread/site" where first observed
_violations: list = []


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Forget recorded edges and violations (per-test isolation).  Held-lock
    stacks are per-thread and self-correct as locks release."""
    with _state_lock:
        _edges.clear()
        _violations.clear()


def violations() -> list:
    with _state_lock:
        return list(_violations)


def take_violations() -> list:
    """Snapshot AND clear -- the conftest teardown consumes them so one
    test's violation never bleeds into the next."""
    with _state_lock:
        out = list(_violations)
        _violations.clear()
        return out


def _record(msg: str) -> None:
    with _state_lock:
        _violations.append(msg)


# --------------------------------------------------------------------------
# lock-order inversion detection
# --------------------------------------------------------------------------

def _stack() -> list:
    st = getattr(_held, "names", None)
    if st is None:
        st = _held.names = []
    return st


def _on_acquire(name: str, oid: int) -> None:
    st = _stack()
    if st:
        tname = threading.current_thread().name
        with _state_lock:
            for h, hid in st:
                if hid == oid:
                    # re-acquiring the very lock we hold: the non-reentrant
                    # wrapped Lock is already deadlocked; nothing to record
                    # that the hang itself won't say louder.
                    continue
                if h == name:
                    # Two DIFFERENT locks sharing a name (instance locks of
                    # one class): without an instance order there is no
                    # consistent global order to check, and nesting them is
                    # the same hazard lockdep flags for same-class locks.
                    _violations.append(
                        f"same-class lock nesting: two locks named {name!r} "
                        f"held together (thread {tname}); give instance "
                        "locks distinct names (make_lock with an instance "
                        "discriminator) or establish an instance order"
                    )
                    continue
                if (name, h) in _edges:
                    msg = (
                        f"lock-order inversion: {h!r} held while acquiring "
                        f"{name!r} (thread {tname}), but the reverse order "
                        f"was observed at {_edges[(name, h)]} -- two threads "
                        "interleaving these orders deadlock"
                    )
                    _violations.append(msg)
                _edges.setdefault((h, name), tname)
    st.append((name, oid))


def _on_release(name: str, oid: int) -> None:
    st = _stack()
    # release order need not be LIFO (lock A, lock B, release A): drop the
    # most recent occurrence.
    for i in range(len(st) - 1, -1, -1):
        if st[i][1] == oid:
            del st[i]
            break


class TsanLock:
    """threading.Lock wrapper feeding the order graph when armed.

    API-compatible with threading.Lock for this repo's usage (acquire/
    release/locked/context manager).  The wrapped lock is real -- the
    harness observes, it does not serialize."""

    __slots__ = ("_lock", "name")

    def __init__(self, name: str):
        self._lock = threading.Lock()
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok and _enabled:
            _on_acquire(self.name, id(self))
        return ok

    def release(self) -> None:
        if _enabled:
            _on_release(self.name, id(self))
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TsanLock {self.name!r} {'locked' if self.locked() else 'unlocked'}>"


def make_lock(name: Optional[str] = None) -> TsanLock:
    """An instrumented lock.  `name` identifies it in the order graph;
    default is the creation site (file:line), which is stable enough for
    module-level locks but give instance locks an explicit name."""
    if name is None:
        f = sys._getframe(1)
        name = f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    return TsanLock(name)


# --------------------------------------------------------------------------
# generation-stale write detection
# --------------------------------------------------------------------------

def check_generation(what: str, began: int, current: int) -> bool:
    """Record a violation if a mutation that began at generation `began` is
    committing while the state sits at `current` (a reset/invalidation ran
    in between -- the abandoned-worker write).  Returns
    True when clean; never raises, never blocks the mutation (production
    guards own behaviour, the harness owns visibility)."""
    if _enabled and began != current:
        _record(
            f"generation-stale write: {what} began at generation {began} "
            f"but the state was reset to generation {current} mid-flight "
            "(zombie worker scribbling on reset state)"
        )
        return False
    return True


class GenerationGuard:
    """Ownership epoch for one device-resident cache object.

    `begin()` captures the epoch before a mutation; `commit(token, action)`
    verifies it right before the mutation lands; `bump()` marks a reset /
    invalidation boundary (watchdog reset hooks, devcache.reset)."""

    __slots__ = ("what", "_gen")

    def __init__(self, what: str):
        self.what = what
        self._gen = 0

    @property
    def generation(self) -> int:
        return self._gen

    def bump(self) -> None:
        self._gen += 1

    def begin(self) -> int:
        return self._gen

    def commit(self, token: int, action: str = "write") -> bool:
        return check_generation(f"{self.what}.{action}", token, self._gen)
