"""Cross-binary trace-context propagation contract.

One trace id follows a claim across all four processes via two carriers:

- **annotation** ``resource.tpu.google.com/traceparent`` on API objects:
  the controller stamps it on everything it creates (the per-domain
  DaemonSet and both ResourceClaimTemplates — on the RCTs it is stamped
  into ``spec.metadata`` as well, so ResourceClaims born from the
  template inherit it); the kubelet plugins extract it from the claim
  they prepare and continue the trace.
- **env var** ``TPU_TRACEPARENT`` in claim CDI edits: the plugin stamps
  the prepare span's context into the container environment, so the
  launcher shim (``workloads/launcher.py``) and the slice-domain daemon
  run as children of the reconcile/prepare that placed them.

Both carry a W3C ``traceparent`` string (span.py).
"""

from __future__ import annotations

import os
from typing import Any, Optional

from tpu_dra_torch.trace.span import SpanContext, current_traceparent

TRACEPARENT_ANNOTATION = "resource.tpu.google.com/traceparent"
TRACEPARENT_ENV = "TPU_TRACEPARENT"


def stamp(obj: dict, context: Optional[SpanContext] = None) -> dict:
    """Stamp the current (or given) span context into
    ``metadata.annotations`` of a to-be-created API object.  No-op
    outside any span; returns ``obj`` for chaining."""
    header = context.to_traceparent() if context is not None \
        else current_traceparent()
    if header:
        obj.setdefault("metadata", {}).setdefault(
            "annotations", {})[TRACEPARENT_ANNOTATION] = header
    return obj


def stamp_template(obj: dict,
                   context: Optional[SpanContext] = None) -> dict:
    """Stamp a ResourceClaimTemplate: both its own metadata AND
    ``spec.metadata`` — the half the API server copies onto every
    ResourceClaim created from the template, which is how the trace
    reaches the kubelet plugin."""
    stamp(obj, context)
    header = context.to_traceparent() if context is not None \
        else current_traceparent()
    if header and "spec" in obj:
        obj["spec"].setdefault("metadata", {}).setdefault(
            "annotations", {})[TRACEPARENT_ANNOTATION] = header
    return obj


def extract(obj: Optional[dict]) -> Optional[SpanContext]:
    """Span context from an API object's traceparent annotation, or
    None when absent/malformed."""
    if not obj:
        return None
    header = obj.get("metadata", {}).get("annotations", {}) \
        .get(TRACEPARENT_ANNOTATION)
    return SpanContext.from_traceparent(header)


def stamp_env(env: dict[str, Any],
              context: Optional[SpanContext] = None) -> dict:
    """Stamp the current (or given) span context into an env mapping
    (claim CDI edits).  An existing value is never clobbered — the
    first writer on a multi-claim container wins, which keeps merged
    edits deterministic."""
    header = context.to_traceparent() if context is not None \
        else current_traceparent()
    if header:
        env.setdefault(TRACEPARENT_ENV, header)
    return env


def extract_env(env: Optional[dict] = None) -> Optional[SpanContext]:
    """Span context from ``TPU_TRACEPARENT``, or None."""
    e = os.environ if env is None else env
    return SpanContext.from_traceparent(e.get(TRACEPARENT_ENV))
