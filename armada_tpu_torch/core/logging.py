"""Structured logging with context-propagated fields.

Equivalent of the reference's armadacontext (internal/common/armadacontext/
armada_context.go) + zerolog structured fields (internal/common/logging):
a context carries key=value fields and every log line emitted under it is
stamped with them, so one request/cycle/executor can be traced across
components without threading loggers through every call.

The port's copy of the JAX package's core/logging.py.

Usage:

    log = get_logger(__name__)
    with log_context(cycle=42, pool="default"):
        log.info("scheduling")          # ... cycle=42 pool=default

Fields nest (inner contexts extend outer ones) and propagate across threads
started via `spawn_with_context` (contextvars do not cross threads on their
own).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import threading
from typing import Any, Callable, Iterator

_FIELDS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "armada_log_fields", default=()
)


@contextlib.contextmanager
def log_context(**fields: Any) -> Iterator[None]:
    """Extend the current logging context with `fields` for the duration."""
    token = _FIELDS.set(_FIELDS.get() + tuple(fields.items()))
    try:
        yield
    finally:
        _FIELDS.reset(token)


def current_fields() -> dict:
    out: dict = {}
    for k, v in _FIELDS.get():
        out[k] = v
    return out


class _ContextFilter(logging.Filter):
    """Stamps records with the ambient fields (filters run for every record,
    unlike adapters, so third-party log calls inside a context get them too)."""

    def filter(self, record: logging.LogRecord) -> bool:
        fields = current_fields()
        record.armada_fields = fields
        suffix = " ".join(f"{k}={v}" for k, v in fields.items())
        record.armada_suffix = f" [{suffix}]" if suffix else ""
        return True


_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s%(armada_suffix)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    """A logger whose records carry the ambient context fields."""
    _ensure_configured()
    logger = logging.getLogger(name)
    if not any(isinstance(f, _ContextFilter) for f in logger.filters):
        logger.addFilter(_ContextFilter())
    return logger


def _ensure_configured() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger("armada_tpu_torch")
    # Self-configure ONLY when nothing else is: if the operator wired the
    # root logger (logging.basicConfig, json shippers, pytest caplog),
    # records must keep propagating there -- hijacking them onto our own
    # stderr handler would bypass the operator's formatting/shipping.
    if not root.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        handler.addFilter(_ContextFilter())
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False


def spawn_with_context(
    target: Callable, *args, daemon: bool = True, **kwargs
) -> threading.Thread:
    """threading.Thread whose body runs under the CURRENT logging context
    (contextvars are per-thread; the reference's armadacontext rides Go's
    ctx through goroutines, this is the Python analog).  Daemon by default:
    a spawned worker wedged on a dead backend must never block process
    exit; pass daemon=False only with an explicit join discipline."""
    ctx = contextvars.copy_context()
    t = threading.Thread(
        target=lambda: ctx.run(target, *args, **kwargs), daemon=daemon
    )
    return t
