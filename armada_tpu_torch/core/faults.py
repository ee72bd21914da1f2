"""Fault-injection harness for resilience drills and tests.

The port's copy of the JAX package's core/faults.py.  The failure modes
the round must survive -- the card hanging mid-round, a CUDA error, a
silently wrong result -- are rare and environment-dependent, so the code
paths that handle them rot unless they can be triggered on demand.
``ARMADA_FAULT`` injects them:

    ARMADA_FAULT=<site>:<mode>[:<after_n>][,<site>:<mode>[:<after_n>]...]

* ``site``  -- an injection point name (see below).
* ``mode``  -- ``error`` (raise), ``hang`` (block, bounded by
  ``ARMADA_FAULT_HANG_S``, default 120 s -- long enough that only a
  watchdog recovers, short enough that abandoned threads drain), or
  ``exit`` (``os._exit(137)``: a real crash, no atexit or finally -- only
  meaningful in subprocess drills).
* ``after_n`` -- skip the first N checks of that entry, fire on check N+1.
  Each entry fires ONCE and then disarms (counters are process-global), so
  a drill injects one deterministic fault and the recovery is observable.

Sites the port wires:

    device_round     the round's device attempt (models.run_round_on_device
                     and the pool-parallel dispatch, before anything is
                     uploaded or launched) -- hang models a wedged card,
                     error a failed launch
    round_corrupt    SILENT corruption of a round, the class as the mode:
                     ``header`` perturbs the result's scheduled_count on
                     the device, ``lane`` points a placement lane at an
                     out-of-range node (models/verify.maybe_corrupt_result),
                     ``bytes`` flips a bit in the FETCHED compact buffer
                     (models/problem._fetch_compact).  Only observable with
                     round verification armed (ARMADA_VERIFY).

Checks read the environment per call and cost one dict lookup when
``ARMADA_FAULT`` is unset.
"""

from __future__ import annotations

import os
import time

from armada_tpu_torch.analysis.tsan import make_lock


class FaultInjected(RuntimeError):
    """An ``error``-mode injected fault.  A RuntimeError, as a CUDA error
    is; the failover ladder names it explicitly (it never catches a bare
    RuntimeError)."""


_lock = make_lock("faults.state")
# (site, mode, after_n) -> number of checks seen / whether it already fired.
_counts: dict[tuple, int] = {}
_fired: set[tuple] = set()


def reset_counters() -> None:
    """Forget check counts and fired state (tests/drills re-arm)."""
    with _lock:
        _counts.clear()
        _fired.clear()


def _parse(spec: str):
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            continue  # malformed entries are ignored, not fatal
        site, mode = parts[0], parts[1]
        try:
            after_n = int(parts[2]) if len(parts) > 2 else 0
        except ValueError:
            continue
        yield site, mode, after_n


def armed(site: str) -> bool:
    """True when ANY entry for `site` is present in ARMADA_FAULT, without
    advancing counters or consuming one-shot state.  The cheap outer gate
    for sites whose check itself has a cost."""
    spec = os.environ.get("ARMADA_FAULT")
    if not spec:
        return False
    return any(s == site for s, _mode, _n in _parse(spec))


def active(site: str, modes=None):
    """The mode to fire for `site` on THIS check, or None.  Advances the
    per-entry check counter; one-shot (an entry never fires twice).

    `modes` restricts which entry modes THIS check point consumes: sites
    whose modes live at different code points (round_corrupt's `header`/
    `lane` fire device-side in models/verify, `bytes` fires at the
    fetched-transfer boundary in models/problem.py) must not advance or
    burn each other's entries -- a filtered-out entry is left untouched
    for its own check point."""
    spec = os.environ.get("ARMADA_FAULT")
    if not spec:
        return None
    for s, mode, after_n in _parse(spec):
        if s != site:
            continue
        if modes is not None and mode not in modes:
            continue
        key = (s, mode, after_n)
        with _lock:
            if key in _fired:
                continue
            n = _counts.get(key, 0)
            _counts[key] = n + 1
            if n < after_n:
                continue
            _fired.add(key)
        return mode
    return None


def check(site: str, exc: type = FaultInjected) -> None:
    """Fire the armed fault for `site`, if any: mode ``error`` raises
    ``exc`` (default FaultInjected), mode ``hang`` blocks for
    ARMADA_FAULT_HANG_S seconds (a bounded stand-in for a wedged card:
    only an external watchdog observes it as a timeout; the hung thread
    eventually drains so tests do not leak forever-threads)."""
    mode = active(site)
    if mode is None:
        return
    if mode == "hang":
        budget = float(os.environ.get("ARMADA_FAULT_HANG_S", 120.0))
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            time.sleep(min(0.05, budget))
        return
    if mode == "exit":
        # A real kill: no exception handlers, no finally blocks, no atexit
        # -- exactly what a power loss looks like to the durable state on
        # disk.  137 = SIGKILL's conventional exit status.
        os._exit(137)
    raise exc(f"injected fault at {site!r}")
