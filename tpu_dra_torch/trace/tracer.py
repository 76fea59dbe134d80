"""The tracer: span lifecycle, automatic parenting, head sampling.

Styled after ``util/metrics.py``: a hand-rolled, dependency-free
module-level default (``get_tracer()`` / ``configure()``) that every
binary shares, with a bounded ring buffer always attached so
``/debug/traces`` has data even when nothing was configured.

Head-based sampling is deterministic in the trace id (the LEADING 8 hex
chars — the high 32 bits — compared against the ratio), so every
process in a distributed trace makes the SAME keep/drop decision
without coordination — the sampled flag still travels in
``traceparent`` and wins when present (a parent's decision is
inherited, never re-rolled).
"""

from __future__ import annotations

import os
import sys
from contextlib import contextmanager
from typing import Any, Iterator, Optional, Union

from tpu_dra_torch.trace.export import (
    JsonlExporter,
    RingBufferExporter,
    SpoolExporter,
)
from tpu_dra_torch.trace.span import (
    _CURRENT,
    NOOP_SPAN,
    NoopSpan,
    Span,
    SpanContext,
    new_span_id,
    new_trace_id,
)

ParentLike = Union[None, str, Span, SpanContext]

# the shared ring every tracer exports into; /debug/traces reads it
DEFAULT_RING = RingBufferExporter(4096)


class _NoopSpanScope:
    """Context manager for a span of an unsampled trace: sets/resets the
    contextvar around the shared :data:`NOOP_SPAN` and nothing else — no
    generator machinery, no clocks, no allocation beyond this one tiny
    object (cheaper than ``@contextmanager`` by ~10x, and the only cost
    an unsampled prepare pays per span)."""

    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _CURRENT.set(NOOP_SPAN)
        return NOOP_SPAN

    def __exit__(self, exc_type, exc, tb):
        _CURRENT.reset(self._token)
        return False


def _head_sampled(trace_id: str, ratio: float) -> bool:
    if ratio >= 1.0:
        return True
    if ratio <= 0.0:
        return False
    return int(trace_id[:8], 16) < int(ratio * 0x1_0000_0000)


def _resolve_parent(parent: ParentLike) -> Optional[SpanContext]:
    if parent is None:
        cur = _CURRENT.get()
        return cur.context if cur is not None else None
    if isinstance(parent, (Span, NoopSpan)):
        # NoopSpan too: an unsampled span handed back as parent= must
        # hand down its unsampled context, not silently re-roll a fresh
        # SAMPLED root (which would export an orphan fragment of a trace
        # every other process dropped)
        return parent.context
    if isinstance(parent, SpanContext):
        return parent
    return SpanContext.from_traceparent(parent)   # str (or garbage → None)


class Tracer:
    def __init__(self, service: str = "", sample_ratio: float = 1.0,
                 exporters: tuple = ()) -> None:
        self.service = service or os.path.basename(sys.argv[0] or "python")
        self.sample_ratio = sample_ratio
        self.exporters = tuple(exporters)

    def start_span(self, name: str, parent: ParentLike = None,
                   attributes: Optional[dict[str, Any]] = None):
        """Open a span for the duration of the ``with`` block.

        ``parent`` may be another span, a :class:`SpanContext`, a
        ``traceparent`` string (as extracted from an annotation or the
        ``TPU_TRACEPARENT`` env), or None — in which case the current
        span (contextvar) parents it, and absent that a new trace root
        is started with a fresh head-sampling decision.  Exceptions are
        recorded on the span and re-raised; the span is exported on exit
        iff its trace is sampled.

        Unsampled traces cost nothing (the zero-cost-when-idle
        invariant, docs/performance.md): every span of a dropped trace
        is the one shared immutable :data:`~tpu_dra_torch.trace.span.NOOP_SPAN`
        — no Span/SpanContext allocation, no urandom ids, no clock
        reads — and only the contextvar is set so nesting and
        propagation (a ``-00`` traceparent) still behave.
        """
        pctx = _resolve_parent(parent)
        if pctx is not None:
            if not pctx.sampled:
                return _NoopSpanScope()
            ctx = SpanContext(trace_id=pctx.trace_id, span_id=new_span_id(),
                              sampled=True)
            parent_id = pctx.span_id
        else:
            if self.sample_ratio <= 0.0:
                # ratio 0 (the production idle default): drop before
                # even generating ids — a root at ratio 0 must not pay
                # for randomness it will never propagate
                return _NoopSpanScope()
            trace_id = new_trace_id()
            if not _head_sampled(trace_id, self.sample_ratio):
                return _NoopSpanScope()
            ctx = SpanContext(trace_id=trace_id, span_id=new_span_id(),
                              sampled=True)
            parent_id = ""
        return self._sampled_span(name, ctx, parent_id, attributes)

    @contextmanager
    def _sampled_span(self, name: str, ctx: SpanContext, parent_id: str,
                      attributes: Optional[dict[str, Any]],
                      ) -> Iterator[Span]:
        span = Span(name, ctx, parent_id=parent_id, service=self.service,
                    attributes=attributes)
        token = _CURRENT.set(span)
        try:
            yield span
        except BaseException as exc:
            span.record_exception(exc)
            raise
        finally:
            _CURRENT.reset(token)
            span.end()
            for exporter in self.exporters:
                exporter.export(span.to_dict())

    def record_span(self, name: str, parent: ParentLike,
                    start: float, duration: float,
                    attributes: Optional[dict[str, Any]] = None,
                    status: str = "ok") -> None:
        """Export an already-finished operation as a span, with explicit
        wall-clock ``start`` and ``duration`` — for work whose lifetime
        was measured by someone else (the continuous engine retires a
        request on the batcher thread long after admission timed it).
        No contextvar is touched; unsampled parents cost one compare."""
        pctx = _resolve_parent(parent)
        if pctx is None or not pctx.sampled:
            return
        ctx = SpanContext(trace_id=pctx.trace_id, span_id=new_span_id(),
                          sampled=True)
        span = Span(name, ctx, parent_id=pctx.span_id,
                    service=self.service, attributes=attributes)
        span.start_time = start
        span.duration = max(duration, 0.0)
        span.status = status
        for exporter in self.exporters:
            exporter.export(span.to_dict())


_DEFAULT = Tracer(exporters=(DEFAULT_RING,))


def configure(service: Optional[str] = None,
              sample_ratio: Optional[float] = None,
              jsonl_path: Optional[str] = None,
              spool_path: Optional[str] = None) -> Tracer:
    """(Re)configure the process-wide default tracer; each binary calls
    this once at startup with its own service name.  The ring buffer
    exporter is always kept; ``jsonl_path`` adds an unbounded file
    sink, ``spool_path`` a size-bounded rotating one for the fleet
    collector (tpu_dra/obs)."""
    global _DEFAULT
    exporters: list = [DEFAULT_RING]
    if jsonl_path:
        exporters.append(JsonlExporter(jsonl_path))
    if spool_path:
        exporters.append(SpoolExporter(spool_path))
    _DEFAULT = Tracer(
        service=service or _DEFAULT.service,
        sample_ratio=(sample_ratio if sample_ratio is not None
                      else _DEFAULT.sample_ratio),
        exporters=tuple(exporters))
    return _DEFAULT


def spool_path_for(spool_dir: str, service: str) -> str:
    """The per-process spool file the collector's directory scan will
    find: service + pid disambiguate concurrent binaries AND a
    respawned worker reusing the service name."""
    return os.path.join(spool_dir, f"{service}-{os.getpid()}.jsonl")


def configure_from_args(args, service: str) -> Tracer:
    """Configure the default tracer from the shared tracing flag group
    (``util/flags.py tracing_flags``) — the one-liner every binary's
    main calls so the setup cannot drift between them."""
    spool_dir = getattr(args, "trace_spool_dir", "") or ""
    spool_path = None
    if spool_dir:
        os.makedirs(spool_dir, exist_ok=True)
        spool_path = spool_path_for(spool_dir, service)
    return configure(service=service,
                     sample_ratio=args.trace_sample_ratio,
                     jsonl_path=args.trace_file or None,
                     spool_path=spool_path)


def get_tracer() -> Tracer:
    return _DEFAULT


def start_span(name: str, parent: ParentLike = None,
               attributes: Optional[dict[str, Any]] = None):
    """Module-level convenience: a span on the default tracer."""
    return _DEFAULT.start_span(name, parent=parent, attributes=attributes)
