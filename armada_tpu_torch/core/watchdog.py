"""Device-reset notifications: the reset-hook registry and the promotion
gate.

The port's copy of the part of the JAX package's core/watchdog.py
(:117-190) that the mesh serving plane needs.  A backend-shaped transition
-- here each rung of the mesh ladder (parallel/serving.py) -- fires the
reset hooks, and every feed replaces its device caches, so the next cycle
uploads its problem anew onto the current placement.  The promotion gate
lets a quarantine veto a restore.

Not ported yet (ROADMAP item 8): the DeviceSupervisor with its deadline,
failure counting and CPU failover rung, `probe_device` and the re-probe
loop that promotes the device again.  Until then nothing degrades on its
own: the port runs the inline discipline.
"""

from __future__ import annotations

import logging
import threading
import weakref
from typing import Callable, Optional

_log = logging.getLogger(__name__)

# Module level, held weakly: a closed feed must not be kept alive by the
# registry, and resetting other process state cannot detach long-lived
# feeds from the notifications.
_reset_hooks: list = []
_hooks_lock = threading.Lock()


def add_reset_hook(fn: Callable[[], None]) -> None:
    """Register a callback fired on every backend transition.  Bound
    methods are held weakly."""
    with _hooks_lock:
        try:
            ref = weakref.WeakMethod(fn)
        except TypeError:
            ref = weakref.ref(fn)
        _reset_hooks.append(ref)


def fire_reset_hooks() -> None:
    """Call every live hook (a failing hook is logged, not raised) and drop
    the dead references."""
    with _hooks_lock:
        hooks = list(_reset_hooks)
    for ref in hooks:
        fn = ref()
        if fn is None:
            continue
        try:
            fn()
        except Exception:
            _log.warning("device reset hook failed", exc_info=True)
    with _hooks_lock:
        _reset_hooks[:] = [r for r in _reset_hooks if r() is not None]


# An optional () -> Optional[str] veto consulted before any re-promotion
# toward the accelerator (the mesh restore).
_promotion_gate: Optional[Callable[[], Optional[str]]] = None


def set_promotion_gate(fn: Optional[Callable[[], Optional[str]]]) -> None:
    global _promotion_gate
    _promotion_gate = fn


def promotion_blocked() -> Optional[str]:
    """The gate's veto reason, or None (no gate / not blocked).  A raising
    gate never blocks -- it must not wedge recovery -- but the fail-open is
    logged."""
    gate = _promotion_gate
    if gate is None:
        return None
    try:
        return gate()
    except Exception:
        _log.error("promotion gate raised; failing OPEN (promotion allowed)", exc_info=True)
        return None
