"""Device-loss watchdog: round deadlines, the CPU failover state, re-probe.

The port's copy of the JAX package's core/watchdog.py.  A card can fail by
hanging (a wedged stream, a kernel that never ends) as well as by raising,
and a scheduler that calls the card inline wedges mid-round while holding
leadership.  This module keeps the serving paths answering:

* ``run_with_deadline`` runs the round in a worker thread under a deadline.
  A timeout ABANDONS the worker (a Python thread cannot be cancelled) and
  raises ``RoundTimeout``; the caller re-runs the round on the failover
  ladder from the host tables (models.run_round_on_device).  An abandoned
  worker that wakes later launches nothing: every launch group of the round
  calls :func:`launch_guard`, which raises in a worker whose attempt was
  abandoned, so a zombie never enqueues work on the stream the next round
  uses, nor touches the kernels' per-stream workspaces.
* ``DeviceSupervisor`` is the process-wide degradation state: the backend
  rounds target ("device" = the card, "cpu" = the CPU rung, where every
  kernel wrapper takes its plain version), consecutive failures, the last
  fallback reason.  A failure fires the registered reset hooks (the
  kernels' workspaces and plans, the feeds' device caches, the stack memo:
  state that lives on a card that is now suspect) and starts a background
  re-probe -- a SUBPROCESS that does one small operation on the card,
  because an in-process probe of a wedged card just hangs too.  After N
  consecutive healthy probes it promotes back to the card, riding one full
  re-upload (the hooks fire again).  Promotion also needs one small launch
  in THIS process, waited for with a bound: after a sticky CUDA error (an
  illegal address) a fresh process can be healthy while this one can no
  longer launch anything; the supervisor then stays degraded and its
  snapshot says why.

Knobs: ``ARMADA_WATCHDOG_S`` (round deadline; 0 = disabled, the default
outside serve, which arms 120 s), ``ARMADA_REPROBE_INTERVAL_S`` (default
30; 0 disables automatic re-promotion), ``ARMADA_REPROBE_HEALTHY``
(consecutive healthy probes to promote, default 2),
``ARMADA_REPROBE_TIMEOUT_S`` (the probe's budget, default 60).
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
import weakref
from typing import Callable, Optional

from armada_tpu_torch.analysis.tsan import make_lock
from armada_tpu_torch.core.logging import get_logger

_log = get_logger(__name__)


class RoundTimeout(RuntimeError):
    """The round exceeded the watchdog deadline (a wedged card)."""


class AttemptAbandoned(Exception):
    """Raised inside a worker whose attempt the watchdog abandoned, at its
    next launch group: the worker stops without launching anything."""


def probe_device(timeout_s: float = 60.0) -> tuple[bool, str]:
    """Subprocess health check of the card: one small matmul on cuda:0, a
    synchronize, and the card's name (a hang is just a timeout out of
    process).  Returns (healthy, detail)."""
    import subprocess

    code = (
        "import torch;"
        "x = torch.ones((128, 128), device='cuda:0');"
        "y = x @ x;"
        "torch.cuda.synchronize();"
        "assert float(y[0, 0]) == 128.0;"
        "print('DEVICE=' + torch.cuda.get_device_name(0))"
    )
    try:
        out = subprocess.run(
            [sys.executable, "-c", code],
            timeout=timeout_s,
            capture_output=True,
            text=True,
        )
    except subprocess.TimeoutExpired:
        return False, f"probe timed out after {timeout_s:.0f}s (card hang)"
    if out.returncode == 0 and "DEVICE=" in out.stdout:
        return True, out.stdout.split("DEVICE=")[-1].strip()
    tail = (out.stderr or out.stdout).strip().splitlines()
    return False, (tail[-1] if tail else f"rc={out.returncode}")[:300]


def launch_check(timeout_s: float = 60.0) -> tuple[bool, str]:
    """One small launch in THIS process and a bounded wait for it (an event
    polled, never a blocking synchronize: on a wedged stream that would
    never return).  Healthy without a card: there is nothing to launch on.
    Returns (healthy, detail)."""
    import torch

    if not torch.cuda.is_available():
        return True, "no card in this process"
    try:
        x = torch.ones((128, 128), device="cuda")
        y = x @ x
        done = torch.cuda.Event()
        done.record()
        deadline = time.monotonic() + timeout_s
        while not done.query():
            if time.monotonic() > deadline:
                return False, f"in-process launch did not finish in {timeout_s:.0f}s"
            time.sleep(0.001)
        if float(y[0, 0]) != 128.0:
            return False, "in-process launch returned a wrong value"
    except Exception as e:  # noqa: BLE001 - a sticky CUDA error lands here
        return False, f"in-process launch failed: {type(e).__name__}: {e}"[:300]
    return True, torch.cuda.get_device_name(0)


# --- attempts and abandoned workers -------------------------------------------

_attempt_gen = itertools.count(1)
_tls = threading.local()
_abandoned: list = []  # worker threads the watchdog gave up on
_abandoned_lock = make_lock("watchdog.abandoned")


class _Attempt:
    """One watchdog attempt: its generation (from one process-wide counter)
    and whether the caller abandoned it.  A worker started from inside an
    attempt inherits it, so abandoning the outer attempt stops both."""

    __slots__ = ("gen", "parent", "abandoned")

    def __init__(self, parent: Optional["_Attempt"]):
        self.gen = next(_attempt_gen)
        self.parent = parent
        self.abandoned = False

    def is_abandoned(self) -> bool:
        a = self
        while a is not None:
            if a.abandoned:
                return True
            a = a.parent
        return False


def launch_guard(what: str = "launch") -> None:
    """Called before every launch group of a round (upload, round,
    compaction, verification, explain, stacking, lane slices, a rollback
    re-run): raises AttemptAbandoned in a worker whose attempt the watchdog
    abandoned.  One thread-local read otherwise."""
    attempt = getattr(_tls, "attempt", None)
    if attempt is not None and attempt.is_abandoned():
        raise AttemptAbandoned(f"{what} skipped: attempt {attempt.gen} was abandoned")


def abandoned_workers() -> list:
    """The abandoned worker threads still alive."""
    with _abandoned_lock:
        _abandoned[:] = [t for t in _abandoned if t.is_alive()]
        return list(_abandoned)


def drain_abandoned(timeout_s: float = 30.0) -> int:
    """Join every abandoned worker (each ends at its drill's bounded hang or
    its next launch group); returns how many are still alive after
    `timeout_s`."""
    deadline = time.monotonic() + timeout_s
    for t in abandoned_workers():
        t.join(max(0.0, deadline - time.monotonic()))
    return len(abandoned_workers())


def run_with_deadline(fn: Callable, deadline_s: float, what: str = "device round"):
    """Run fn() in a daemon worker; return its result, re-raise its
    exception, or abandon it and raise RoundTimeout after `deadline_s`.
    With no deadline (`deadline_s` <= 0, the watchdog unarmed) fn() runs
    inline in the caller's thread.

    An abandoned worker is not cancelled: it runs on until its next
    launch_guard, which stops it (or until whatever blocks it ends).  The
    worker's trace spans nest under the caller's open span (ops/trace
    capture/adopt); a worker that outlives its cycle records nothing."""
    from armada_tpu_torch.ops.trace import recorder as _trace_recorder

    if deadline_s <= 0:
        return fn()
    rec = _trace_recorder()
    handle = rec.capture() if rec.enabled else None
    attempt = _Attempt(getattr(_tls, "attempt", None))
    box: dict = {}

    def _worker():
        _tls.attempt = attempt
        rec.adopt(handle)
        try:
            box["result"] = fn()
        except AttemptAbandoned:
            pass  # the caller is gone; nothing was launched
        except BaseException as e:  # noqa: BLE001 - transported to the caller
            box["error"] = e

    t = threading.Thread(target=_worker, daemon=True, name=f"watchdog:{what}")
    t.start()
    t.join(deadline_s)
    if t.is_alive():
        attempt.abandoned = True
        with _abandoned_lock:
            _abandoned.append(t)
        raise RoundTimeout(f"{what} exceeded {deadline_s:.1f}s deadline")
    if "error" in box:
        raise box["error"]
    return box["result"]


# --- reset hooks and the promotion gate ----------------------------------------

# Module level, held weakly: a closed feed must not be kept alive by the
# registry, and reset_supervisor() cannot detach long-lived feeds from the
# notifications.
_reset_hooks: list = []
_hooks_lock = make_lock("watchdog.reset_hooks")


def add_reset_hook(fn: Callable[[], None]) -> None:
    """Register a callback fired on EVERY backend transition (a fallback to
    the CPU rung, a promotion back to the card, each rung of the mesh
    ladder).  Bound methods are held weakly."""
    with _hooks_lock:
        try:
            ref = weakref.WeakMethod(fn)
        except TypeError:
            ref = weakref.ref(fn)
        _reset_hooks.append(ref)


def fire_reset_hooks() -> None:
    """Call every live hook (a failing hook is logged, not raised) and drop
    the dead references.  The supervisor fires it on its own transitions;
    the mesh serving ladder (parallel/serving.py) on every degrade and
    restore."""
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
# toward the card (DeviceSupervisor.promote and the mesh restore).  The
# device quarantine registers it (scheduler/quarantine.py): a card whose
# rounds keep failing verification must not be re-promoted by a healthy
# probe, which cannot see silent corruption.
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


# --- the supervisor -------------------------------------------------------------


class DeviceSupervisor:
    """Process-wide device-backend health state."""

    def __init__(self):
        self._lock = make_lock("watchdog.supervisor")
        self.backend = "device"  # "device" = the card; "cpu" = the CPU rung
        self.consecutive_failures = 0
        self.fallbacks = 0
        self.promotions = 0
        self.last_failure: Optional[str] = None
        self.last_fallback_ts: Optional[float] = None
        self.last_promotion_refusal: Optional[str] = None
        self._deadline_s: Optional[float] = None
        self._armings: dict[int, float] = {}
        self._arm_seq = 0
        self._reprobe_interval_s: Optional[float] = None
        self._healthy_checks: Optional[int] = None
        self._probe = probe_device  # patchable in tests
        self._local_check = launch_check  # patchable in tests
        self._reprobe_thread: Optional[threading.Thread] = None

    # --- config ---------------------------------------------------------------

    def configure(
        self,
        deadline_s: Optional[float] = None,
        reprobe_interval_s: Optional[float] = None,
        healthy_checks: Optional[int] = None,
    ) -> None:
        """Explicit settings beat the environment's defaults."""
        if deadline_s is not None:
            self._deadline_s = float(deadline_s)
        if reprobe_interval_s is not None:
            self._reprobe_interval_s = float(reprobe_interval_s)
        if healthy_checks is not None:
            self._healthy_checks = int(healthy_checks)

    def arm(self, deadline_s: float) -> int:
        """Scoped arming for a control plane inside a larger process:
        returns a token for disarm().  Reference-counted, not save/restore:
        planes overlap and stop in any order, so deadline_s() takes the max
        over live registrations."""
        with self._lock:
            self._arm_seq += 1
            token = self._arm_seq
            self._armings[token] = float(deadline_s)
        return token

    def disarm(self, token: int) -> None:
        with self._lock:
            self._armings.pop(token, None)

    def deadline_s(self) -> float:
        """The armed round deadline; <= 0 means the watchdog is disabled
        (the inline discipline)."""
        with self._lock:
            if self._armings:
                return max(self._armings.values())
        if self._deadline_s is not None:
            return self._deadline_s
        try:
            return float(os.environ.get("ARMADA_WATCHDOG_S", "0"))
        except ValueError:
            return 0.0

    def reprobe_interval_s(self) -> float:
        if self._reprobe_interval_s is not None:
            return self._reprobe_interval_s
        try:
            return float(os.environ.get("ARMADA_REPROBE_INTERVAL_S", "30"))
        except ValueError:
            return 30.0

    def healthy_checks(self) -> int:
        if self._healthy_checks is not None:
            return self._healthy_checks
        try:
            return int(os.environ.get("ARMADA_REPROBE_HEALTHY", "2"))
        except ValueError:
            return 2

    @property
    def degraded(self) -> bool:
        return self.backend == "cpu"

    # --- transitions ------------------------------------------------------------

    def record_failure(self, reason: str) -> None:
        """A round on the card failed (timeout, CUDA error, drill, refused
        verification): degrade to the CPU rung, fire the reset hooks, start
        the re-probe."""
        with self._lock:
            self.consecutive_failures += 1
            self.fallbacks += 1
            self.last_failure = str(reason)[:500]
            self.last_fallback_ts = time.time()
            was_degraded = self.backend == "cpu"
            self.backend = "cpu"
        _log.error(
            "device round failed (%s); scheduling degraded to the CPU rung (failure %d)",
            reason,
            self.consecutive_failures,
        )
        # on the transition and on repeat failures alike: a failure on the
        # CPU rung still means device-resident state is suspect
        fire_reset_hooks()
        if not was_degraded or self._reprobe_thread is None:
            self._start_reprobe()

    def record_success(self) -> None:
        with self._lock:
            self.consecutive_failures = 0

    def promote(self) -> bool:
        """Re-promote rounds to the card; the reset hooks fire, so the next
        cycle rides one full re-upload.  Returns False, staying degraded,
        while the promotion gate vetoes (a quarantined card is re-admitted
        only by an operator clear) or while this process cannot launch on
        the card (the snapshot's `promotion_refused` says why)."""
        blocked = promotion_blocked()
        if blocked:
            self.last_promotion_refusal = blocked[:300]
            _log.warning("device probes healthy but promotion is blocked: %s", blocked)
            return False
        with self._lock:
            if self.backend == "device":
                return True
        timeout = float(os.environ.get("ARMADA_REPROBE_TIMEOUT_S", "60"))
        ok, detail = self._local_check(timeout)
        if not ok:
            self.last_promotion_refusal = detail[:300]
            _log.error("device probes healthy but this process cannot launch: %s", detail)
            return False
        with self._lock:
            if self.backend == "device":
                return True
            self.backend = "device"
            self.consecutive_failures = 0
            self.promotions += 1
            self.last_promotion_refusal = None
        _log.warning("device healthy again: re-promoting (the next cycle pays one full re-upload)")
        fire_reset_hooks()
        return True

    # --- re-probe -------------------------------------------------------------

    def _start_reprobe(self) -> None:
        interval = self.reprobe_interval_s()
        if interval <= 0:
            return  # the operator (or a test) promotes
        with self._lock:
            if self._reprobe_thread is not None and self._reprobe_thread.is_alive():
                return
            t = threading.Thread(target=self._reprobe_loop, daemon=True, name="device-reprobe")
            self._reprobe_thread = t
        t.start()

    def _reprobe_loop(self) -> None:
        timeout = float(os.environ.get("ARMADA_REPROBE_TIMEOUT_S", "60"))
        healthy = 0
        need = self.healthy_checks()
        while self.degraded and _SUPERVISOR is self:
            time.sleep(self.reprobe_interval_s())
            if not self.degraded or _SUPERVISOR is not self:
                break
            ok, detail = self._probe(timeout)
            if ok:
                healthy += 1
                _log.info("device re-probe healthy (%s): %d/%d", detail, healthy, need)
                if healthy >= need and self.promote():
                    break
                # blocked (quarantine, or this process cannot launch): keep
                # polling at the probe cadence
            else:
                healthy = 0
                _log.info("device re-probe still failing: %s", detail)
        with self._lock:
            self._reprobe_thread = None

    # --- export ---------------------------------------------------------------

    def snapshot(self) -> dict:
        # deadline_s() takes the lock itself: resolve it first (the lock is
        # not reentrant)
        deadline = self.deadline_s()
        with self._lock:
            return {
                "backend": self.backend,
                "consecutive_failures": self.consecutive_failures,
                "fallbacks": self.fallbacks,
                "promotions": self.promotions,
                "last_fallback_reason": self.last_failure,
                "last_fallback_ts": self.last_fallback_ts,
                "watchdog_deadline_s": deadline,
                "promotion_refused": self.last_promotion_refusal,
            }


_SUPERVISOR = DeviceSupervisor()


def supervisor() -> DeviceSupervisor:
    return _SUPERVISOR


def reset_supervisor() -> DeviceSupervisor:
    """Fresh supervisor state (tests).  Reset hooks and the promotion gate
    are module-level and survive; a re-probe thread of the old instance
    ends at its next poll."""
    global _SUPERVISOR
    _SUPERVISOR = DeviceSupervisor()
    return _SUPERVISOR


def data_device(device="cuda"):
    """Where device-resident problem data should live right now: the CPU
    while the supervisor is degraded, else `device` (the card unless the
    caller asked for the CPU).  models/slab.py routes every upload through
    it, so the delta cache keeps its O(delta) scatters on the CPU rung."""
    import torch

    if _SUPERVISOR.degraded:
        return torch.device("cpu")
    return torch.device(device)
