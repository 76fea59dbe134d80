"""Span primitives, copied from ``tpu_dra/trace/span.py``: W3C trace
context and the contextvar current span.

- :class:`SpanContext` — (trace_id, span_id, sampled), with W3C
  ``traceparent`` encode/decode (https://www.w3.org/TR/trace-context/),
  the wire format a request's ``traceparent`` header and the
  ``TPU_TRACEPARENT`` environment variable carry
  (:mod:`tpu_dra_torch.trace.propagation`);
- :class:`Span` — one timed operation with attributes, events, and
  error recording;
- a ``contextvars``-based *current span*, so nested
  ``Tracer.start_span`` calls parent automatically and a histogram
  observed inside a sampled span takes its trace id as an exemplar
  (``util/metrics.py``) without the call site knowing about tracing.

Dependency-free (stdlib only, no other imports of the port), so the
metrics module can import it without cycles.
"""

from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from dataclasses import dataclass
from types import MappingProxyType
from typing import Any, Optional

# traceparent: version "00" = exactly 4 dash-separated fields
_TRACEPARENT_VERSION = "00"
_FLAG_SAMPLED = 0x01
_HEX = set("0123456789abcdef")


def _is_hex(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


# Trace/span ids need uniqueness, not cryptographic strength, and
# ``os.urandom`` is a getrandom(2) syscall per call — measured ~8.5us on
# the bench container, paid TWICE per sampled span.  A process-local
# PRNG seeded from urandom once is ~20x cheaper; it is reseeded after
# fork so a forked worker cannot replay the parent's id stream
# (duplicate span ids would silently merge unrelated traces).
_rng = random.Random(os.urandom(16))
if hasattr(os, "register_at_fork"):   # pragma: no branch
    os.register_at_fork(
        after_in_child=lambda: _rng.seed(os.urandom(16)))


def new_trace_id() -> str:
    return f"{_rng.getrandbits(128) or 1:032x}"


def new_span_id() -> str:
    return f"{_rng.getrandbits(64) or 1:016x}"


@dataclass(frozen=True)
class SpanContext:
    """The propagated identity of a span: what crosses process edges."""

    trace_id: str            # 32 lowercase hex chars, not all zero
    span_id: str             # 16 lowercase hex chars, not all zero
    sampled: bool = True

    def to_traceparent(self) -> str:
        flags = _FLAG_SAMPLED if self.sampled else 0
        return (f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-"
                f"{flags:02x}")

    @staticmethod
    def from_traceparent(header: Optional[str]) -> Optional["SpanContext"]:
        """Parse a ``traceparent`` header; None on anything malformed.

        Per the W3C spec: version ``ff`` is invalid, all-zero trace/span
        ids are invalid, field widths are fixed; an unknown (non-ff)
        version is accepted as long as the first four fields parse —
        forward compatibility — but version 00 must have exactly four.
        """
        if not header or not isinstance(header, str):
            return None
        parts = header.strip().split("-")
        if len(parts) < 4:
            return None
        version, trace_id, span_id, flags = parts[0], parts[1], parts[2], \
            parts[3]
        if len(version) != 2 or not _is_hex(version) or version == "ff":
            return None
        if version == _TRACEPARENT_VERSION and len(parts) != 4:
            return None
        if len(trace_id) != 32 or not _is_hex(trace_id) or \
                trace_id == "0" * 32:
            return None
        if len(span_id) != 16 or not _is_hex(span_id) or \
                span_id == "0" * 16:
            return None
        if len(flags) != 2 or not _is_hex(flags):
            return None
        return SpanContext(trace_id=trace_id, span_id=span_id,
                           sampled=bool(int(flags, 16) & _FLAG_SAMPLED))


class Span:
    """One timed operation.  Created by ``Tracer.start_span``; not
    thread-safe (a span belongs to the thread/context that opened it)."""

    def __init__(self, name: str, context: SpanContext,
                 parent_id: str = "", service: str = "",
                 attributes: Optional[dict[str, Any]] = None) -> None:
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.service = service
        self.thread = threading.current_thread().name
        self.start_time = time.time()        # wall clock, for the viewer
        self._t0 = time.perf_counter()       # monotonic, for duration
        self.duration: Optional[float] = None
        self.attributes: dict[str, Any] = dict(attributes or {})
        self.events: list[dict[str, Any]] = []
        self.status = "ok"

    # -- recording ---------------------------------------------------------
    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        self.events.append({"name": name, "ts": time.time(), **attrs})

    def record_exception(self, exc: BaseException) -> None:
        self.status = "error"
        self.attributes["error"] = repr(exc)[:200]

    def end(self) -> None:
        if self.duration is None:
            self.duration = time.perf_counter() - self._t0

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "service": self.service,
            "trace_id": self.context.trace_id,
            "span_id": self.context.span_id,
            "parent_id": self.parent_id,
            "sampled": self.context.sampled,
            "thread": self.thread,
            "start": self.start_time,
            "duration": self.duration if self.duration is not None else 0.0,
            "status": self.status,
            "attributes": dict(self.attributes),
            "events": list(self.events),
        }


# -- the shared no-op span (zero-cost-when-idle invariant) -----------------
# An unsampled trace must cost its spans nothing: no SpanContext/Span
# allocation, no urandom span id, no clock reads, no attribute dict — a
# prepare at sample ratio 0 pays one contextvar set/reset per span and
# nothing else (docs/performance.md).  One immutable instance is shared
# by every unsampled span in the process; recording methods are no-ops
# and its context is a FIXED valid-but-unsampled SpanContext, so
# propagation still stamps a ``...-00`` traceparent and every downstream
# binary makes the same drop decision without re-rolling a root.
NOOP_CONTEXT = SpanContext(trace_id="0" * 31 + "1",
                           span_id="0" * 15 + "1", sampled=False)

class NoopSpan:
    """The do-nothing span standing in for every span of an unsampled
    trace.  Immutable and shared — never export it, never mutate it."""

    __slots__ = ()

    name = ""
    context = NOOP_CONTEXT
    parent_id = ""
    service = ""
    thread = ""
    start_time = 0.0
    duration: Optional[float] = 0.0
    status = "ok"
    # immutable views: an accidental direct writer fails loudly instead
    # of silently poisoning every unsampled span in the process
    attributes = MappingProxyType({})
    events: tuple = ()

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def add_event(self, name: str, **attrs: Any) -> None:
        pass

    def record_exception(self, exc: BaseException) -> None:
        pass

    def end(self) -> None:
        pass

    def to_dict(self) -> dict[str, Any]:
        # defensive: exporters must never be handed a noop span, but a
        # caller that serializes current_span() should not crash
        return {"name": "noop", "trace_id": NOOP_CONTEXT.trace_id,
                "span_id": NOOP_CONTEXT.span_id, "sampled": False}


NOOP_SPAN = NoopSpan()

# the current span for this execution context: nested start_span calls
# parent automatically; threads do NOT inherit it (workqueue captures
# the enqueuer's context explicitly instead)
_CURRENT: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "tpu_dra_torch_current_span", default=None)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_context() -> Optional[SpanContext]:
    span = _CURRENT.get()
    return span.context if span is not None else None


def current_traceparent() -> str:
    """``traceparent`` of the current span, or "" outside any span.
    Inside an unsampled (noop) span this is the fixed unsampled context —
    still stamped, so downstream processes inherit the drop decision."""
    ctx = current_context()
    return ctx.to_traceparent() if ctx is not None else ""


def current_ids() -> Optional[tuple[str, str]]:
    """(trace_id, span_id) of the current span — klog's hook.  None
    inside a noop span: the shared unsampled ids would stamp every log
    line of every unsampled request with one meaningless constant."""
    span = _CURRENT.get()
    if span is None or span is NOOP_SPAN:
        return None
    ctx = span.context
    return (ctx.trace_id, ctx.span_id)
