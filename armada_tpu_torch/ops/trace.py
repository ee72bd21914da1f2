"""Cycle tracing: a correlated span timeline for the serving plane.

The port's copy of the JAX package's ops/trace.py.  Every other figure is an
aggregate; this answers "where did *this* cycle's time go?" across the
pipelined dispatch, a watchdog failover re-run and the verify/explain
passes: a process-global, always-cheap span recorder the cycle is
instrumented with, exported as Chrome trace-event JSON (Perfetto-loadable),
a health block and per-stage latency histograms.

Design constraints:

* **One clock.**  Every timestamp is :func:`ops.metrics.mono_now`, the
  single monotonic source; the Chrome export emits offsets from each
  trace's root.  Stage times are HOST wall time: a span never synchronizes
  the card (no ``.item()``, no ``synchronize``, no event wait inside it),
  so a dispatch span covers the enqueue and the blocking fetch span covers
  the device work it waited for.
* **Zero allocation when off.**  ``span()`` returns a shared no-op context
  manager unless a cycle is active and tracing is enabled
  (``ARMADA_TRACE=0`` disables).  Armed, a span costs one small object and
  two clock reads.
* **Bounded memory.**  Finished cycle trees land in a ring of the last N
  cycles (``ARMADA_TRACE_RING``, default 16); per-cycle span counts are
  capped (``_SPAN_CAP``) and overflow is counted on the root.
* **Decision-neutral.**  The recorder only reads clocks and appends to
  lists; tracing armed or not yields identical decisions.
* **Cross-thread spans attach to the cycle.**  The watchdog worker runs on
  another thread; :meth:`TraceRecorder.capture` / :meth:`adopt` nest its
  spans under the caller's open span, and a span opened on a thread with
  no open span parents to the active cycle's root.  A worker that outlives
  its cycle records nothing (the zombie guard).
* **The device profiler bridge.**  With ``ARMADA_TRACE_TORCH=1`` every span
  also opens ``torch.profiler.record_function`` (so a torch.profiler
  capture carries the span names beside the kernels) and, on a card,
  ``torch.cuda.nvtx.range`` (the same names on an NVTX timeline).  Neither
  synchronizes.

Readers: :func:`chrome_trace`, :meth:`TraceRecorder.healthz_block`,
:meth:`TraceRecorder.stage_snapshot` and :meth:`TraceRecorder.last_stages`.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Optional

from armada_tpu_torch.analysis.tsan import make_lock
from armada_tpu_torch.ops.metrics import MetricsRegistry, mono_now

# Hard per-cycle span cap: a runaway instrumentation loop must degrade to a
# counted overflow, never an unbounded tree.
_SPAN_CAP = 200_000


class Span:
    """One timed region.  ``t0``/``t1`` are mono_now() seconds; ``args``
    is a small JSON-able dict (bytes counts, row counts, reasons)."""

    __slots__ = ("name", "t0", "t1", "tid", "args", "children")

    def __init__(self, name: str, t0: float, tid: int, args: Optional[dict]):
        self.name = name
        self.t0 = t0
        self.t1 = t0
        self.tid = tid
        self.args = args
        self.children: list = []

    @property
    def dur_s(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def to_dict(self, base: float) -> dict:
        """Offset-based serialization (relative to ``base``): monotonic
        epochs differ across processes, so the wire form carries only
        offsets + durations -- graft() re-bases them in the receiver's
        timeline."""
        out = {
            "name": self.name,
            "off_s": round(self.t0 - base, 9),
            "dur_s": round(self.dur_s, 9),
        }
        if self.tid:
            out["tid"] = self.tid
        if self.args:
            out["args"] = self.args
        if self.children:
            out["children"] = [c.to_dict(base) for c in self.children]
        return out


class CycleTrace:
    """One finished (or active) cycle's span tree."""

    __slots__ = (
        "trace_id", "kind", "pid", "root", "span_count", "overflow",
        "finished",
    )

    def __init__(self, trace_id: str, kind: str, root: Span):
        self.trace_id = trace_id
        self.kind = kind
        self.pid = os.getpid()
        self.root = root
        self.span_count = 1
        self.overflow = 0
        # Zombie-writer guard (the devcache GenerationGuard's idea, in
        # miniature): a watchdog-abandoned worker that unwedges after its
        # cycle finalized must not keep growing the ring entry or charge
        # span counts to whatever cycle is primary by then -- span()/note()
        # drop work whose owning trace is finished.
        self.finished = False

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "kind": self.kind,
            "pid": self.pid,
            "duration_s": round(self.root.dur_s, 9),
            "root": self.root.to_dict(self.root.t0),
        }
        if self.overflow:
            d["span_overflow"] = self.overflow
        return d


class _NoopSpan:
    """Shared do-nothing context manager: the disabled/idle fast path
    allocates NOTHING per span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _SpanCtx:
    """Context manager for one armed span: pushes onto the thread's open
    stack on enter, stamps t1 and pops on exit."""

    __slots__ = ("_rec", "_span", "_bridge")

    def __init__(self, rec: "TraceRecorder", span: Span):
        self._rec = rec
        self._span = span
        self._bridge = None

    def __enter__(self):
        stack = self._rec._stack()
        stack.append(self._span)
        if self._rec._torch_bridge:
            self._bridge = _enter_torch(self._span.name)
        return self._span

    def __exit__(self, *exc):
        if self._bridge is not None:
            for ctx in reversed(self._bridge):
                try:
                    ctx.__exit__(*exc)
                except Exception:  # noqa: BLE001 - profiler teardown is best-effort
                    pass
        self._span.t1 = mono_now()
        stack = self._rec._stack()
        if stack and stack[-1] is self._span:
            stack.pop()
        else:  # tolerate exotic unwind orders (watchdog-abandoned threads)
            try:
                stack.remove(self._span)
            except ValueError:
                pass
        return False


class _CycleCtx:
    """Context manager for a cycle root; finalizes into the ring."""

    __slots__ = ("_rec", "_trace", "_span_ctx")

    def __init__(self, rec: "TraceRecorder", trace: CycleTrace):
        self._rec = rec
        self._trace = trace
        self._span_ctx = _SpanCtx(rec, trace.root)

    def __enter__(self):
        self._rec._tls.trace = self._trace
        self._span_ctx.__enter__()
        return self._trace

    def __exit__(self, *exc):
        self._span_ctx.__exit__(*exc)
        self._rec._finish_cycle(self._trace)
        return False


def _gen_trace_id() -> str:
    # uuid4 without the uuid import cost on every cycle: 16 random hex
    # bytes from os.urandom (no clock involved -- lint scope).
    return os.urandom(16).hex()


class TraceRecorder:
    """Process-global span recorder (singleton via :func:`recorder`)."""

    def __init__(self, ring: Optional[int] = None):
        if ring is None:
            try:
                ring = int(os.environ.get("ARMADA_TRACE_RING", "16"))
            except ValueError:
                ring = 16
        self.ring: deque = deque(maxlen=max(1, ring))
        self.registry = MetricsRegistry("trace")
        # Active cycles are PER-THREAD (a sidecar session's round on a gRPC
        # worker must not nest into an unrelated cycle that happens to be
        # open on another thread -- in-process client+server is a real test
        # topology); `_primary` is the fallback for spans opened on threads
        # with no cycle of their own (the watchdog worker, shadow thunks).
        self._active_by_thread: dict[int, CycleTrace] = {}
        self._primary: Optional[CycleTrace] = None
        self._tls = threading.local()
        self._lock = make_lock("trace.recorder")
        self._torch_bridge = os.environ.get("ARMADA_TRACE_TORCH") == "1"
        self.nested_cycles = 0  # cycle() while this thread already had one

    # ------------------------------------------------------------- state ----

    @property
    def enabled(self) -> bool:
        return os.environ.get("ARMADA_TRACE", "1") != "0"

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def active(self) -> Optional[CycleTrace]:
        """This thread's open cycle, else the process's primary one."""
        t = self._active_by_thread.get(threading.get_ident())
        return t if t is not None else self._primary

    def capture(self) -> Optional[tuple]:
        """(owning trace, span) new work on this thread would attach to --
        the handle a worker thread passes to :meth:`adopt`."""
        owner, parent = self._resolve()
        return None if owner is None else (owner, parent)

    def adopt(self, handle: Optional[tuple]) -> None:
        """Seed THIS thread's span stack with a (trace, span) handle
        captured on another thread (core/watchdog's round worker): spans
        opened here nest under the caller's open span -- e.g.
        kernel_dispatch under the round span -- instead of flattening onto
        the cycle root, so the stage histograms (direct children of the
        root) never double-count worker time that also elapses inside the
        caller's span.  For ONE-SHOT threads: the seeded frame is never
        popped.  The owning trace rides along so the zombie guard can
        refuse spans once that cycle finalizes."""
        if handle is None:
            return
        owner, parent = handle
        if parent is None:
            return
        self._tls.trace = owner
        self._stack().append(parent)

    def _resolve(self) -> tuple:
        """(owning trace, parent span) for new work on this thread: the
        innermost open span here (owned by the thread's recorded trace),
        else the active cycle's root.  (None, None) when no LIVE cycle is
        reachable -- including the zombie case where this thread's trace
        already finalized."""
        stack = self._stack()
        if stack:
            owner = getattr(self._tls, "trace", None)
            if owner is None:
                owner = self.active()
            if owner is None or owner.finished:
                return None, None
            return owner, stack[-1]
        owner = self.active()
        if owner is None or owner.finished:
            return None, None
        # record the owner so nested spans opened from this root-attached
        # one charge the SAME trace even if the primary moves meanwhile
        self._tls.trace = owner
        return owner, owner.root

    # ----------------------------------------------------------- writers ----

    def cycle(self, name: str, trace_id: str = "", kind: str = "", **args):
        """Begin a cycle trace: the root every span until exit attaches to.
        ``trace_id`` stitches across processes (the sidecar boundary passes
        the caller's).  Re-entrant use (a cycle inside a cycle) degrades to
        a plain span of the outer cycle, so nesting can never corrupt the
        ring."""
        if not self.enabled:
            return _NOOP
        tid = threading.get_ident()
        if tid in self._active_by_thread:
            self.nested_cycles += 1
            return self.span(name, **args)
        root = Span(name, mono_now(), tid, args or None)
        trace = CycleTrace(trace_id or _gen_trace_id(), kind or name, root)
        with self._lock:
            self._active_by_thread[tid] = trace
            if self._primary is None:
                self._primary = trace
        return _CycleCtx(self, trace)

    def span(self, name: str, **args):
        """A timed region inside the active cycle; no-op (shared object,
        zero allocation) when disabled or no live cycle is reachable."""
        if not self.enabled:
            return _NOOP
        owner, parent = self._resolve()
        if owner is None:
            return _NOOP
        if owner.span_count >= _SPAN_CAP:
            owner.overflow += 1
            return _NOOP
        span = Span(name, mono_now(), threading.get_ident(), args or None)
        parent.children.append(span)
        owner.span_count += 1
        return _SpanCtx(self, span)

    def note(self, name: str, **args) -> None:
        """Instant event (zero-duration span): per-transfer bytes, cache
        resets.  Same no-op economics as span()."""
        if not self.enabled:
            return
        owner, parent = self._resolve()
        if owner is None:
            return
        if owner.span_count >= _SPAN_CAP:
            owner.overflow += 1
            return
        span = Span(name, mono_now(), threading.get_ident(), args or None)
        parent.children.append(span)
        owner.span_count += 1

    def annotate(self, **args) -> None:
        """Attach args to the owning cycle's root (failover reason,
        degraded flag): attribution survives even when the annotating code
        runs deep inside a worker thread."""
        if not self.enabled:
            return
        owner, _parent = self._resolve()
        if owner is None:
            return
        if owner.root.args is None:
            owner.root.args = {}
        owner.root.args.update(args)

    def graft(self, remote: dict, under: Optional[Span] = None) -> None:
        """Attach a REMOTE process's serialized span tree (Span.to_dict
        offset form, as shipped in the sidecar response) beneath the
        current span: offsets re-base at the graft point's start, so the
        remote spans land inside the RPC span that covered them.  The
        remote pid keeps its own track in the Chrome export."""
        if not self.enabled:
            return
        if under is not None:
            parent = under
        else:
            owner, parent = self._resolve()
            if owner is None:
                return
        if parent is None:
            return

        def build(d: dict, base: float, root: bool) -> Span:
            s = Span(d.get("name", "remote"), base + float(d.get("off_s", 0.0)), 0, None)
            s.t1 = s.t0 + float(d.get("dur_s", 0.0))
            args = dict(d.get("args") or {})
            if root:
                # only the graft ROOT is marked remote (+ carries the
                # remote pid): the Chrome exporter switches the process
                # track there and descendants inherit it.
                args.setdefault("remote", True)
            s.args = args or None
            s.children = [
                build(c, base, False) for c in d.get("children", ())
            ]
            return s

        grafted = build(remote, parent.t0, True)
        parent.children.append(grafted)

    def _finish_cycle(self, trace: CycleTrace) -> None:
        with self._lock:
            trace.finished = True
            tid = threading.get_ident()
            if self._active_by_thread.get(tid) is trace:
                del self._active_by_thread[tid]
            if getattr(self._tls, "trace", None) is trace:
                self._tls.trace = None
            if self._primary is trace:
                self._primary = next(
                    iter(self._active_by_thread.values()), None
                )
            self.ring.append(trace)
        # Stage histograms: the root's DIRECT children are the cycle's
        # stages; same-named stages within one cycle accumulate.
        by_stage: dict[str, float] = {}
        for child in trace.root.children:
            by_stage[child.name] = by_stage.get(child.name, 0.0) + child.dur_s
        for stage, dur in by_stage.items():
            self.registry.histogram(f"stage.{stage}").record(dur)
        self.registry.histogram("cycle").record(trace.root.dur_s)

    # ----------------------------------------------------------- readers ----

    def last(self, n: Optional[int] = None) -> list:
        with self._lock:
            traces = list(self.ring)
        return traces if n is None else traces[-n:]

    def stage_snapshot(self) -> dict:
        """Per-stage latency distributions (the prometheus + bench feed)."""
        return self.registry.snapshot()

    def last_stages(self) -> dict:
        """stage -> seconds for the newest finished cycle (bench's
        stage_*_s keys; deterministic, unlike the histograms)."""
        traces = self.last(1)
        if not traces:
            return {}
        out: dict[str, float] = {}
        for child in traces[-1].root.children:
            out[child.name] = out.get(child.name, 0.0) + child.dur_s
        return out

    def healthz_block(self) -> dict:
        """The /healthz ``trace`` block: last cycle's identity + top spans
        by duration (flattened), small enough to read at a glance."""
        traces = self.last(1)
        if not traces:
            return {"cycles": len(self.ring)}
        t = traces[-1]
        return {
            "cycles": len(self.ring),
            "trace_id": t.trace_id,
            "kind": t.kind,
            "duration_s": round(t.root.dur_s, 6),
            "args": t.root.args or {},
            "top_spans": top_spans(t.root.to_dict(t.root.t0)),
        }

    def dump(self) -> dict:
        """Offset-form dump of the whole ring (the wire/disk form
        a trace reader consumes)."""
        return {"traces": [t.to_dict() for t in self.last()]}

    def reset(self) -> None:
        with self._lock:
            self.ring.clear()
            self._active_by_thread.clear()
            self._primary = None
        self.registry.reset()


def _enter_torch(name: str) -> Optional[list]:
    """The device-profiler bridge (ARMADA_TRACE_TORCH=1): the span's name as
    a torch.profiler ``record_function`` range, and on a card as an NVTX
    range, so a profiler capture lines up with this module's timeline.
    Neither waits for the card.  Returns the entered contexts (exited in
    reverse), or None when torch cannot open them."""
    try:
        import torch
    except ImportError:  # pragma: no cover - the port always has torch
        return None
    entered = []
    try:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        entered.append(rf)
        if torch.cuda.is_available():
            nv = torch.cuda.nvtx.range(name)
            nv.__enter__()
            entered.append(nv)
    except Exception:  # noqa: BLE001 - tracing must never break the cycle
        pass
    return entered or None


def top_spans(root: dict, n: int = 12) -> list:
    """The N longest spans of one offset-form tree (Span.to_dict), each as
    ``{"name", "depth", "dur_s"}`` -- the ONE flatten/rank implementation
    behind the health report's trace block."""
    flat: list[tuple[float, str, int]] = []

    def walk(d: dict, depth: int) -> None:
        for c in d.get("children", ()):
            flat.append((float(c.get("dur_s", 0.0)), c.get("name", ""), depth))
            walk(c, depth + 1)

    walk(root, 1)
    flat.sort(reverse=True)
    return [
        {"name": name, "depth": depth, "dur_s": round(dur, 6)}
        for dur, name, depth in flat[:n]
    ]


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto-loadable)
# ---------------------------------------------------------------------------

def chrome_trace(traces=None, recorder_: Optional[TraceRecorder] = None) -> dict:
    """Chrome trace-event JSON for a set of cycle traces.

    ``traces`` may be CycleTrace objects or their offset-form dicts (the
    dump()/wire shape) -- a reader stitches a REMOTE plane's dump
    without reconstructing objects.  Cycles are laid out sequentially on a
    shared timeline (each cycle's root starts where exporting placed it),
    with ``ph: "X"`` complete events, ``ph: "i"`` instants for
    zero-duration notes, and ``ph: "M"`` process/thread metadata --
    exactly the fields Perfetto's JSON importer requires (name, ph, ts,
    dur, pid, tid).
    """
    rec = recorder_ if recorder_ is not None else recorder()
    if traces is None:
        traces = rec.last()
    events: list[dict] = []
    tracks_seen: set = set()
    cursor_us = 0.0

    def emit_meta(pid: int, tid: int, pname: str) -> None:
        if (pid, 0) not in tracks_seen:
            tracks_seen.add((pid, 0))
            events.append(
                {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "args": {"name": pname}}
            )
        if (pid, tid) not in tracks_seen:
            tracks_seen.add((pid, tid))
            events.append(
                {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                 "args": {"name": f"thread-{tid}"}}
            )

    def emit(d: dict, origin_us: float, pid_here: int, trace_id: str,
             tid_inherit: int) -> float:
        args = dict(d.get("args") or {})
        tid = int(d.get("tid", tid_inherit)) or tid_inherit
        if args.pop("remote", False):
            # graft root: switch to the remote process's track; the
            # recursion carries the switched pid to every descendant.
            pid_here = int(args.pop("pid", pid_here + 1_000_000))
            tid = 1
            emit_meta(pid_here, tid, f"armada-remote-{pid_here}")
        else:
            emit_meta(pid_here, tid, f"armada-{pid_here}")
        ts = origin_us + float(d.get("off_s", 0.0)) * 1e6
        dur = float(d.get("dur_s", 0.0)) * 1e6
        args["trace_id"] = trace_id
        ev = {"name": d.get("name", "span"), "cat": "armada",
              "pid": pid_here, "tid": tid}
        if dur <= 0.0 and not d.get("children"):
            ev.update({"ph": "i", "ts": ts, "s": "t", "args": args})
        else:
            ev.update({"ph": "X", "ts": ts, "dur": max(dur, 0.001),
                       "args": args})
        events.append(ev)
        end = ts + dur
        for c in d.get("children", ()):  # children are offset from the ROOT
            end = max(end, emit(c, origin_us, pid_here, trace_id, tid))
        return end

    for t in traces:
        doc = t.to_dict() if isinstance(t, CycleTrace) else t
        pid = int(doc.get("pid", os.getpid()))
        root = doc.get("root", {})
        end = emit(root, cursor_us, pid, doc.get("trace_id", ""), 1)
        cursor_us = end + 1000.0  # 1ms gutter between cycles
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# process-global singleton (the watchdog-supervisor / SLO-recorder idiom)
# ---------------------------------------------------------------------------

_recorder: Optional[TraceRecorder] = None
_recorder_lock = make_lock("trace.global")


def recorder() -> TraceRecorder:
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = TraceRecorder()
        return _recorder


def reset_recorder(ring: Optional[int] = None) -> TraceRecorder:
    """Fresh process-global recorder (tests/bench arms)."""
    global _recorder
    with _recorder_lock:
        _recorder = TraceRecorder(ring=ring)
        return _recorder
