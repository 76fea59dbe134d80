"""Prometheus text exposition for the port's serving front end, copied
from ``tpu_dra/util/metrics.py``: ``Counter``, ``Gauge``, ``Histogram``
(with OpenMetrics exemplars), ``Registry``, ``bounded_label``, the plain
(0.0.4) text format and the OpenMetrics 1.0 format.

The output is byte-for-byte the reference's, so dashboards, the router
and the parity tests read both servers alike.  A histogram observed
inside a sampled span (``tpu_dra_torch.trace``) keeps that span's trace
id as the bucket's exemplar; :func:`negotiate_exposition` answers
OpenMetrics, exemplars included, to a client that asks for it once a
histogram holds one, and the plain text otherwise.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

# span.py is stdlib-only, so this import cannot cycle; an unsampled span
# is the shared NOOP_SPAN, recognized by identity at no cost
from tpu_dra_torch.trace.span import _CURRENT as _CURRENT_SPAN, NOOP_SPAN

# the exemplar label keys the exposition accepts: the only link the
# exemplars promise is metric -> trace
EXEMPLAR_LABELS = ("trace_id", "span_id")

OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
TEXT_CONTENT_TYPE = "text/plain; version=0.0.4"


def negotiate_exposition(accept: str, registry: "Registry"
                         ) -> tuple[str, str]:
    """(body, content-type) for a /metrics request: OpenMetrics when the
    client asked for it and the registry holds exemplars; the plain
    0.0.4 text every scraper parses otherwise."""
    if "application/openmetrics-text" in (accept or "") and \
            registry.has_exemplars():
        return registry.expose(openmetrics=True), OPENMETRICS_CONTENT_TYPE
    return registry.expose(), TEXT_CONTENT_TYPE


def bounded_label(raw: Optional[str], *,
                  allowed: Optional[frozenset] = None,
                  seen: Optional[set] = None,
                  cap: int = 64,
                  lock: Optional[threading.Lock] = None,
                  overflow: str = "other",
                  empty: str = "default",
                  max_len: int = 64) -> str:
    """Bound an untrusted string into a safe metric-label value.

    - **allowlist** (``allowed=``): values outside the fixed set
      collapse into ``overflow`` (request paths).
    - **first-come registry** (``seen=``): the first ``cap`` distinct
      values keep their own series, everything later collapses into
      ``overflow``; pass the owning ``lock`` when callers race (tenants).

    Either way the value is length-clamped and stripped of ``~`` first,
    so an overflow sentinel containing ``~`` can never be claimed by a
    client-chosen value."""
    value = (raw or empty).replace("~", "_")[:max_len] or empty
    if allowed is not None:
        return value if value in allowed else overflow
    if seen is None:
        return value
    if lock is not None:
        with lock:
            return _admit_label(seen, value, cap, overflow)
    return _admit_label(seen, value, cap, overflow)


def _admit_label(seen: set, value: str, cap: int, overflow: str) -> str:
    if value in seen:
        return value
    if len(seen) < cap:
        seen.add(value)
        return value
    return overflow


def _current_exemplar() -> Optional[dict]:
    """``{"trace_id": ...}`` of the current sampled span, else None."""
    span = _CURRENT_SPAN.get()
    if span is None or span is NOOP_SPAN:
        return None
    return {"trace_id": span.context.trace_id}


def _escape_label(value: object) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote and line-feed."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escape_help(text: str) -> str:
    """HELP lines escape backslash and line-feed (no quote escaping)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _simple_exposition(name: str, help_: str, kind: str,
                       labels: tuple[str, ...],
                       items: list[tuple[tuple[str, ...], float]],
                       family: Optional[str] = None) -> str:
    """Text exposition for single-sample-per-series metrics (counter,
    gauge): the HELP/TYPE header and one escaped line per label set.
    ``family`` overrides the HELP/TYPE name (OpenMetrics strips a
    counter's ``_total`` there; the sample lines keep it)."""
    fam = family or name
    out = [f"# HELP {fam} {_escape_help(help_)}",
           f"# TYPE {fam} {kind}"]
    for lv, val in sorted(items):
        lbl = ",".join(f'{k}="{_escape_label(v)}"'
                       for k, v in zip(labels, lv))
        out.append(f"{name}{{{lbl}}} {val}" if lbl else f"{name} {val}")
    return "\n".join(out)


def _cell_items(cell: dict) -> list:
    while True:
        try:
            return list(cell.items())
        except RuntimeError:
            # the owner thread inserted a new label set mid-iteration;
            # re-snapshot (bounded by the label cardinality)
            continue


class _Cells:
    """Per-thread accumulation cells: each thread writes only its own
    dict (single writer, safe under the GIL, no lock per update) and a
    read sums across cells.  Cells of dead threads fold into a retired
    accumulator at read time, so a thread-per-connection server does not
    grow one cell per connection forever."""

    def __init__(self, merge) -> None:
        self._merge = merge          # (acc dict, cell dict) -> None
        self._cells: list[tuple[threading.Thread, dict]] = []  # _mu
        self._retired: dict = {}                               # _mu
        self._tl = threading.local()
        self._mu = threading.Lock()

    def mine(self) -> dict:
        try:
            return self._tl.cell
        except AttributeError:
            cell: dict = {}
            with self._mu:
                self._cells.append((threading.current_thread(), cell))
            self._tl.cell = cell
            return cell

    def totals(self) -> dict:
        # fold, copy and snapshot in one critical section: a concurrent
        # read must not fold a just-died cell we still hold as live
        with self._mu:
            live = []
            for owner, cell in self._cells:
                if owner.is_alive():
                    live.append((owner, cell))
                else:
                    self._merge(self._retired, cell)
            self._cells = live
            totals = {lv: (list(v) if isinstance(v, list) else v)
                      for lv, v in self._retired.items()}
            cells = [cell for _, cell in live]
        for cell in cells:
            self._merge(totals, cell)
        return totals


def _merge_sums(acc: dict, cell: dict) -> None:
    for lv, val in _cell_items(cell):
        acc[lv] = acc.get(lv, 0.0) + val


def _merge_lists(acc: dict, cell: dict) -> None:
    for lv, s in _cell_items(cell):
        dst = acc.get(lv)
        if dst is None:
            acc[lv] = list(s)
        else:
            for i, v in enumerate(list(s)):
                dst[i] += v


def _merge_newest(acc: dict, cell: dict) -> None:
    """Exemplar cells (per label set, one ``(labels, value, ts)`` or None
    per bucket): the newest exemplar of each bucket wins."""
    for lv, exs in _cell_items(cell):
        dst = acc.get(lv)
        if dst is None:
            acc[lv] = list(exs)
            continue
        for i, ex in enumerate(list(exs)):
            if ex is not None and (dst[i] is None or ex[2] > dst[i][2]):
                dst[i] = ex


class Counter:
    """Monotonic counter with a lock-free ``inc()`` (per-thread cells)."""

    KIND = "counter"

    def __init__(self, name: str, help_: str, labels: tuple[str, ...] = ()):
        self.name, self.help, self.labels = name, help_, labels
        self._cells = _Cells(_merge_sums)

    def inc(self, *label_values: str, by: float = 1.0) -> None:
        cell = self._cells.mine()
        cell[label_values] = cell.get(label_values, 0.0) + by

    def value(self, *label_values: str) -> float:
        """Current total for one label set."""
        return self._cells.totals().get(label_values, 0.0)

    def totals(self) -> dict[tuple[str, ...], float]:
        """All label sets with their totals (the SLO tracker's read)."""
        return self._cells.totals()

    def collect(self, openmetrics: bool = False) -> str:
        family = None
        if openmetrics and self.name.endswith("_total"):
            family = self.name[: -len("_total")]
        return _simple_exposition(self.name, self.help, self.KIND,
                                  self.labels, list(self.totals().items()),
                                  family=family)


class Gauge:
    """Last-writer-wins gauge (a lock per call: no gauge sits on a hot
    path)."""

    KIND = "gauge"

    def __init__(self, name: str, help_: str, labels: tuple[str, ...] = ()):
        self.name, self.help, self.labels = name, help_, labels
        self._values: dict[tuple[str, ...], float] = {}
        self._mu = threading.Lock()

    def set(self, value: float, *label_values: str) -> None:
        with self._mu:
            self._values[label_values] = value

    def inc(self, *label_values: str, by: float = 1.0) -> None:
        with self._mu:
            self._values[label_values] = \
                self._values.get(label_values, 0.0) + by

    def value(self, *label_values: str) -> float:
        with self._mu:
            return self._values.get(label_values, 0.0)

    def values(self) -> dict[tuple[str, ...], float]:
        with self._mu:
            return dict(self._values)

    def collect(self, openmetrics: bool = False) -> str:
        return _simple_exposition(self.name, self.help, self.KIND,
                                  self.labels, list(self.values().items()))


class Histogram:
    """Histogram with a lock-free ``observe()`` (per-thread cells of
    ``label values -> [bucket counts..., overflow, sum]``) and OpenMetrics
    exemplars.

    An observation inside a sampled span remembers ``(trace_id, value,
    timestamp)`` for the bucket it landed in (the newest per bucket wins
    at collect time); the OpenMetrics exposition prints it as ``...
    # {trace_id="..."} value ts``.  An unsampled observation pays two
    pointer compares.  An explicit ``exemplar={"trace_id": ...}``
    overrides the ambient span; its keys are restricted to
    :data:`EXEMPLAR_LABELS`."""

    KIND = "histogram"
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)

    def __init__(self, name: str, help_: str,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                 labels: tuple[str, ...] = ()):
        if any(b1 >= b2 for b1, b2 in zip(buckets, buckets[1:])):
            raise ValueError(
                f"histogram {name!r} buckets must be strictly "
                f"increasing, got {buckets}")
        self.name, self.help, self.buckets = name, help_, tuple(buckets)
        self.labels = labels
        self._cells = _Cells(_merge_lists)
        self._ex = _Cells(_merge_newest)
        self._has_exemplars = False     # latched on the first exemplar

    def observe(self, value: float, *label_values: str,
                exemplar: Optional[dict] = None) -> None:
        # validated before anything is recorded: a refused exemplar must
        # not leave the observation half-written
        if exemplar and any(k not in EXEMPLAR_LABELS for k in exemplar):
            raise ValueError(
                f"exemplar labels restricted to {EXEMPLAR_LABELS}, "
                f"got {tuple(exemplar)}")
        cell = self._cells.mine()
        s = cell.get(label_values)
        if s is None:
            s = cell[label_values] = [0] * (len(self.buckets) + 1) + [0.0]
        s[-1] += value
        idx = len(self.buckets)
        for i, b in enumerate(self.buckets):
            if value <= b:
                idx = i
                break
        s[idx] += 1
        if exemplar is None:
            exemplar = _current_exemplar()
        if exemplar:
            ex = self._ex.mine()
            slots = ex.get(label_values)
            if slots is None:
                slots = ex[label_values] = [None] * (len(self.buckets) + 1)
            slots[idx] = (dict(exemplar), float(value), time.time())
            self._has_exemplars = True          # a latch: benign race

    def has_exemplars(self) -> bool:
        return self._has_exemplars

    def snapshot(self) -> dict[tuple[str, ...], dict]:
        """Per label set: cumulative finite-bucket counts, total count,
        and sum (the SLO tracker's read)."""
        out = {}
        for lv, s in self._cells.totals().items():
            cumulative = []
            cum = 0
            for c in s[: len(self.buckets)]:
                cum += c
                cumulative.append(cum)
            out[lv] = {"cumulative": cumulative,
                       "count": cum + s[len(self.buckets)],
                       "sum": s[-1]}
        return out

    @staticmethod
    def _format_exemplar(ex: tuple) -> str:
        labels, value, ts = ex
        lbl = ",".join(f'{k}="{_escape_label(v)}"'
                       for k, v in sorted(labels.items()))
        return f" # {{{lbl}}} {value} {round(ts, 3)}"

    def collect(self, openmetrics: bool = False) -> str:
        """Text exposition; exemplars appear only in the OpenMetrics
        form (0.0.4 parsers reject the ``# {...}`` suffix), so the plain
        text is the same with or without them."""
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} histogram"]
        exemplars = self._ex.totals() if openmetrics else {}
        for lv, s in sorted(self._cells.totals().items()):
            lbl = ",".join(f'{k}="{_escape_label(v)}"'
                           for k, v in zip(self.labels, lv))
            pre = lbl + "," if lbl else ""
            exs = exemplars.get(lv) or [None] * (len(self.buckets) + 1)
            cum = 0
            for b, c, ex in zip(self.buckets, s, exs):
                cum += c
                line = f'{self.name}_bucket{{{pre}le="{b}"}} {cum}'
                out.append(line + self._format_exemplar(ex) if ex else line)
            cum += s[len(self.buckets)]
            line = f'{self.name}_bucket{{{pre}le="+Inf"}} {cum}'
            ex = exs[len(self.buckets)]
            out.append(line + self._format_exemplar(ex) if ex else line)
            suffix = f"{{{lbl}}}" if lbl else ""
            out.append(f"{self.name}_sum{suffix} {s[-1]}")
            out.append(f"{self.name}_count{suffix} {cum}")
        return "\n".join(out)


class Registry:
    """Metric registry, idempotent by name: re-requesting an existing
    name returns the existing instance (same kind and signature
    required)."""

    def __init__(self) -> None:
        self._metrics: dict[str, tuple] = {}
        self._mu = threading.Lock()

    def _get_or_register(self, cls, name, *args):
        with self._mu:
            existing, sig = self._metrics.get(name, (None, None))
            if existing is not None:
                if type(existing) is not cls or sig != args:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{sig}, requested "
                        f"{cls.__name__}{args}")
                return existing
            metric = cls(name, *args)
            self._metrics[name] = (metric, args)
            return metric

    def counter(self, name: str, help_: str,
                labels: tuple[str, ...] = ()) -> Counter:
        return self._get_or_register(Counter, name, help_, labels)

    def gauge(self, name: str, help_: str,
              labels: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_register(Gauge, name, help_, labels)

    def histogram(self, name: str, help_: str,
                  buckets: tuple[float, ...] = Histogram.DEFAULT_BUCKETS,
                  labels: tuple[str, ...] = ()) -> Histogram:
        return self._get_or_register(Histogram, name, help_, buckets, labels)

    def has_exemplars(self) -> bool:
        """Whether any histogram holds an exemplar: the /metrics content
        negotiation's predicate."""
        with self._mu:
            metrics = [m for m, _ in self._metrics.values()]
        return any(isinstance(m, Histogram) and m.has_exemplars()
                   for m in metrics)

    def expose(self, openmetrics: bool = False) -> str:
        """The text exposition of every metric: Prometheus 0.0.4 by
        default; ``openmetrics=True`` gives OpenMetrics 1.0 (counter
        families without ``_total`` in HELP/TYPE, exemplars on histogram
        buckets, ``# EOF`` last)."""
        with self._mu:
            metrics = [m for m, _ in self._metrics.values()]
        body = "\n".join(m.collect(openmetrics=openmetrics)
                         for m in metrics) + "\n"
        return body + "# EOF\n" if openmetrics else body


# the process-wide registry (the trace ring's eviction counter lands here)
DEFAULT_REGISTRY = Registry()
