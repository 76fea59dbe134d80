"""Span exporters + the Perfetto/Chrome trace-event converter.

Two sinks, both bounded-cost so tracing can stay on in production:

- :class:`RingBufferExporter` — fixed-capacity in-memory ring; the
  backing store of the ``/debug/traces`` endpoint (util/metrics.py).
- :class:`JsonlExporter` — append-one-JSON-object-per-line file sink
  for offline analysis; I/O errors are swallowed (tracing is advisory,
  it must never take the process down).

:func:`chrome_trace` renders exported span dicts as Chrome trace-event
JSON (the ``{"traceEvents": [...]}`` object format), directly loadable
in Perfetto (https://ui.perfetto.dev) and ``chrome://tracing``: one
``"ph": "X"`` complete event per span, pid = service (process), tid =
thread, with metadata events naming both.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Any, Optional

_ring_dropped = None


def _ring_dropped_counter():
    """The ring-eviction counter, registered lazily: tracing must stay
    importable (and cheap) before metrics is configured, and the
    counter only matters once a ring actually overflows."""
    global _ring_dropped
    if _ring_dropped is None:
        from tpu_dra_torch.util.metrics import DEFAULT_REGISTRY
        _ring_dropped = DEFAULT_REGISTRY.counter(
            "tpu_dra_trace_spans_dropped_total",
            "finished spans evicted from the bounded in-memory trace "
            "ring before anything read them")
    return _ring_dropped


class RingBufferExporter:
    """Bounded in-memory span store (newest wins on overflow).

    Evictions are counted (``tpu_dra_trace_spans_dropped_total``): a
    trace id that 404s on ``/debug/traces`` because the ring rolled
    over is a capacity fact the operator can see, not a silent hole."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self.dropped = 0                    # guarded by self._mu
        self._mu = threading.Lock()
        self._spans: collections.deque = collections.deque(
            maxlen=capacity)   # guarded by self._mu

    def export(self, span: dict[str, Any]) -> None:
        with self._mu:
            evicting = len(self._spans) == self.capacity
            self._spans.append(span)
            if evicting:
                self.dropped += 1
        if evicting:
            _ring_dropped_counter().inc()

    def spans(self, trace_id: Optional[str] = None) -> list[dict[str, Any]]:
        with self._mu:
            snap = list(self._spans)
        if trace_id:
            snap = [s for s in snap if s.get("trace_id") == trace_id]
        return snap

    def clear(self) -> None:
        with self._mu:
            self._spans.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._spans)


class JsonlExporter:
    """Append finished spans to a JSONL file (one span object per line)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._mu = threading.Lock()

    def export(self, span: dict[str, Any]) -> None:
        line = json.dumps(span, default=str)
        try:
            with self._mu, open(self.path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
        except OSError:
            pass   # advisory: a full disk must not kill the traced process


class SpoolExporter:
    """Size-bounded JSONL span spool for the fleet collector
    (``tpu_dra/obs``): like :class:`JsonlExporter`, but when the file
    crosses ``max_bytes`` it rotates to ``<path>.1`` (replacing the
    previous generation) and starts fresh — two generations bound the
    disk cost of an always-on spool, and a collector polling faster
    than one generation's fill time loses nothing.  Spans lost to a
    rotation the collector never read show up as a gap in its
    ``tpu_dra_obs_spans_dropped_total`` accounting, not here: the spool
    cannot know who read it."""

    def __init__(self, path: str, max_bytes: int = 8 << 20) -> None:
        self.path = path
        self.max_bytes = max_bytes
        self._size = -1                     # guarded by _mu; -1 = unknown
        self._mu = threading.Lock()

    def export(self, span: dict[str, Any]) -> None:
        line = json.dumps(span, default=str) + "\n"
        try:
            with self._mu:
                if self._size < 0:
                    try:
                        self._size = os.path.getsize(self.path)
                    except OSError:
                        self._size = 0
                if self._size + len(line) > self.max_bytes:
                    os.replace(self.path, self.path + ".1")
                    self._size = 0
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
                self._size += len(line)
        except OSError:
            pass   # advisory, same contract as JsonlExporter


def chrome_trace(spans: list[dict[str, Any]]) -> dict[str, Any]:
    """Span dicts → Chrome trace-event JSON (Perfetto-loadable).

    Services map to synthetic pids and thread names to per-service tids,
    with ``"M"`` metadata events carrying the human-readable names; each
    span becomes one complete (``"X"``) event with its ids and
    attributes in ``args``.
    """
    pids: dict[str, int] = {}
    tids: dict[tuple[str, str], int] = {}
    events: list[dict[str, Any]] = []
    for s in spans:
        service = s.get("service") or "unknown"
        thread = s.get("thread") or "main"
        if service not in pids:
            pids[service] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[service], "tid": 0,
                           "args": {"name": service}})
        key = (service, thread)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == service]) + 1
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pids[service], "tid": tids[key],
                           "args": {"name": thread}})
        args = {
            "trace_id": s.get("trace_id", ""),
            "span_id": s.get("span_id", ""),
            "parent_id": s.get("parent_id", ""),
            "status": s.get("status", ""),
            **(s.get("attributes") or {}),
        }
        if s.get("events"):
            args["events"] = s["events"]
        events.append({
            "name": s.get("name", "span"),
            "cat": "span",
            "ph": "X",
            "ts": round(float(s.get("start", 0.0)) * 1e6, 3),
            "dur": max(round(float(s.get("duration") or 0.0) * 1e6, 3),
                       0.001),
            "pid": pids[service],
            "tid": tids[key],
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def spans_from_chrome(doc: dict[str, Any]) -> list[dict[str, Any]]:
    """The inverse of :func:`chrome_trace`: Chrome trace-event JSON (as
    served by ``/debug/traces``) back into span dicts, so the fleet
    collector (``tpu_dra/obs``) can ingest live endpoints with the same
    merge path as spool files.  Kept next to ``chrome_trace`` so the
    two directions cannot drift: the ``M`` metadata events restore the
    service/thread names the forward direction synthesized into
    pid/tid."""
    services: dict[int, str] = {}
    threads: dict[tuple[int, int], str] = {}
    spans: list[dict[str, Any]] = []
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "M":
            args = ev.get("args") or {}
            if ev.get("name") == "process_name":
                services[ev.get("pid", 0)] = args.get("name", "")
            elif ev.get("name") == "thread_name":
                threads[(ev.get("pid", 0), ev.get("tid", 0))] = \
                    args.get("name", "")
        elif ph == "X":
            args = dict(ev.get("args") or {})
            span = {
                "name": ev.get("name", "span"),
                "service": services.get(ev.get("pid", 0), ""),
                "thread": threads.get(
                    (ev.get("pid", 0), ev.get("tid", 0)), ""),
                "trace_id": args.pop("trace_id", ""),
                "span_id": args.pop("span_id", ""),
                "parent_id": args.pop("parent_id", ""),
                "status": args.pop("status", "ok"),
                "start": float(ev.get("ts", 0.0)) / 1e6,
                "duration": float(ev.get("dur", 0.0)) / 1e6,
                "events": args.pop("events", []),
            }
            span["attributes"] = args
            spans.append(span)
    return spans


# /debug/traces responses are bounded by default: a 4096-span ring
# renders to multiple MB of Chrome JSON, so an uncapped endpoint is a
# self-DoS for whatever scrapes it.  ?limit= raises or lowers the cap
# (clamped to the ring capacity); newest spans win, matching the ring's
# own eviction order.
DEBUG_TRACES_DEFAULT_LIMIT = 1024


def debug_traces_body(path: str) -> tuple[int, bytes]:
    """``(status, body)`` for ``/debug/traces[?trace_id=…][&limit=…]``:
    the default span ring as Chrome trace JSON.  ONE implementation
    shared by the driver binaries' HTTP endpoint (util/metrics.py) and
    the serve binary's handler — the exemplar→trace resolution contract
    must not drift between them.  A ``trace_id`` filter that matches
    nothing returns a TYPED 404 (the id was evicted from the bounded
    ring, or never sampled) instead of an empty Perfetto shell an
    operator would stare at.  ``default=str``: one exotic span
    attribute must degrade to its str(), not kill the endpoint until
    the span ages out of the ring."""
    from urllib.parse import parse_qs, urlparse

    # lazy: the ring lives in tracer.py, which imports this module
    from tpu_dra_torch.trace.tracer import DEFAULT_RING

    qs = parse_qs(urlparse(path).query)
    trace_id = qs.get("trace_id", [""])[0]
    try:
        limit = int(qs.get("limit", [str(DEBUG_TRACES_DEFAULT_LIMIT)])[0])
    except ValueError:
        return 400, json.dumps(
            {"error": "limit must be an integer"}).encode()
    limit = max(1, min(limit, DEFAULT_RING.capacity))
    spans = DEFAULT_RING.spans(trace_id=trace_id or None)
    if trace_id and not spans:
        return 404, json.dumps({
            "error": "trace_id not found: evicted from the bounded "
                     "span ring or never sampled on this process",
            "trace_id": trace_id,
            "ring_capacity": DEFAULT_RING.capacity,
            "ring_dropped_total": DEFAULT_RING.dropped,
        }).encode()
    spans = spans[-limit:]              # newest win, like the ring
    return 200, json.dumps(chrome_trace(spans), default=str).encode()
