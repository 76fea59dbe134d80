"""Distributed tracing of the port, copied from ``tpu_dra/trace``: spans
with automatic (contextvar) parenting, W3C ``traceparent`` propagation,
head sampling, bounded in-memory and JSONL export, and Chrome
trace-event rendering for the server's ``/debug/traces`` endpoint
(Perfetto-loadable).

The formats are the reference's, so one trace id crosses a client, the
reference's router, a JAX replica and a PyTorch replica alike, and the
two packages' ``/debug/traces`` answers read the same way.  The port
keeps its own copy (it imports nothing of ``tpu_dra``): its spans live
in its own ring and its own contextvar.
"""

from tpu_dra_torch.trace import propagation  # noqa: F401
from tpu_dra_torch.trace.export import (  # noqa: F401
    JsonlExporter,
    RingBufferExporter,
    SpoolExporter,
    chrome_trace,
    spans_from_chrome,
)
from tpu_dra_torch.trace.propagation import (  # noqa: F401
    TRACEPARENT_ANNOTATION,
    TRACEPARENT_ENV,
)
from tpu_dra_torch.trace.span import (  # noqa: F401
    NOOP_SPAN,
    NoopSpan,
    Span,
    SpanContext,
    current_context,
    current_ids,
    current_span,
    current_traceparent,
)
from tpu_dra_torch.trace.tracer import (  # noqa: F401
    DEFAULT_RING,
    Tracer,
    configure,
    configure_from_args,
    get_tracer,
    start_span,
)

__all__ = [
    "DEFAULT_RING",
    "JsonlExporter",
    "NOOP_SPAN",
    "NoopSpan",
    "RingBufferExporter",
    "Span",
    "SpanContext",
    "SpoolExporter",
    "TRACEPARENT_ANNOTATION",
    "TRACEPARENT_ENV",
    "Tracer",
    "chrome_trace",
    "spans_from_chrome",
    "configure",
    "configure_from_args",
    "current_context",
    "current_ids",
    "current_span",
    "current_traceparent",
    "get_tracer",
    "propagation",
    "start_span",
]
