"""Goodput accounting of training, copied from
``tpu_dra/workloads/goodput.py``: the wall clock of a training process
segmented into productive steps and everything else, exported as
Prometheus series and kept in a state file that survives restarts.

Segments (the ``segment`` label on ``tpu_goodput_seconds_total``):

- ``step``      — productive optimizer steps (the goodput numerator)
- ``compile``   — the first step of a run (first-use costs: kernel
  builds, allocator growth)
- ``checkpoint_save`` / ``restore`` — the durability tax, measured
  inside ``workloads/checkpointing.py`` so every caller pays into the
  right segment without instrumenting itself
- ``reconfiguration`` — downtime between a worker's death and its
  respawn, recorded by a supervisor (``record_downtime``)
- ``blocked``   — everything unaccounted (data stalls, waits): the
  catch-all, so the segments always sum to wall time

The state file (``TPU_GOODPUT_FILE``, schema ``tpu-goodput/v1``, the
reference's) carries the totals across processes: a worker merges its
segments into it as it runs, and a restarted worker loads the merged
totals as its baseline, so the goodput ratio survives any number of
restarts.  The two packages read each other's files.

An un-started tracker's ``measure()`` returns one shared no-op context
manager: the hooks in ``fit`` and ``checkpointing`` cost a dict lookup
and nothing else for runs that never opted in.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from tpu_dra_torch.trace import get_tracer
from tpu_dra_torch.trace.span import SpanContext
from tpu_dra_torch.util.metrics import DEFAULT_REGISTRY, Registry

SEG_STEP = "step"
SEG_COMPILE = "compile"
SEG_CHECKPOINT_SAVE = "checkpoint_save"
SEG_RESTORE = "restore"
SEG_RECONFIGURATION = "reconfiguration"
SEG_BLOCKED = "blocked"
SEGMENTS = (SEG_STEP, SEG_COMPILE, SEG_CHECKPOINT_SAVE, SEG_RESTORE,
            SEG_RECONFIGURATION, SEG_BLOCKED)

# the cross-process state-file contract (see module docstring); the
# elastic supervisor injects it into every worker it spawns
STATE_ENV = "TPU_GOODPUT_FILE"

_SCHEMA = "tpu-goodput/v1"


class _NoopMeasure:
    """Shared do-nothing measurement — what ``measure()`` hands back
    before ``start()`` so instrumented call sites cost nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_MEASURE = _NoopMeasure()


class _Measure:
    __slots__ = ("_tracker", "_segment")

    def __init__(self, tracker: "GoodputTracker", segment: str) -> None:
        self._tracker = tracker
        self._segment = segment

    def __enter__(self):
        self._tracker._enter(self._segment)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracker._exit(self._segment)
        return False


class GoodputTracker:
    """Wall-clock segmentation with Prometheus export and an optional
    cross-process state file.

    Thread-safety: accounting state is lock-guarded, but nested
    ``measure()`` scopes form one stack — the tracker belongs to the
    train loop's thread (the same single-owner contract as a trace
    span).  The supervisor-side ``record_downtime`` path takes only the
    lock and never the stack, so the two never interleave."""

    def __init__(self, registry: Optional[Registry] = None,
                 window_s: float = 600.0,
                 state_path: Optional[str] = None,
                 flush_interval_s: float = 1.0) -> None:
        self._registry = registry if registry is not None \
            else DEFAULT_REGISTRY
        self.state_path = state_path
        self._window_s = window_s
        self._flush_interval_s = flush_interval_s
        self._mu = threading.Lock()
        # all below guarded by _mu
        self._started = False
        self._t_last = 0.0
        # True once THIS process opened a measure() scope: only a
        # measuring process owns the between-measures "blocked" time.
        # A supervisor-side tracker (record_downtime only) must never
        # accrue the interval the worker is alive — the worker accounts
        # it itself through the shared ledger
        self._measured = False
        self._stack: list[str] = []
        self._local: dict[str, float] = {}     # accrued THIS process
        self._baseline: dict[str, float] = {}  # loaded from state file
        self._records: list[dict] = []         # local reconfigurations
        self._baseline_records: list[dict] = []
        self._window: deque = deque()          # (t, segment, dt)
        self._last_flush = 0.0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "GoodputTracker":
        with self._mu:
            if self._started:
                return self
            self._started = True
            self._t_last = time.monotonic()
            if self.state_path:
                merged = _load_state(self.state_path)
                self._baseline = dict(merged.get("totals", {}))
                self._baseline_records = list(
                    merged.get("reconfigurations", []))
            # tpu_goodput_* is the TENANT-side workload namespace (like
            # tpu_serve_*) — exempt from the driver's tpu_dra_* contract
            self._seconds = self._registry.counter(
                "tpu_goodput_seconds_total",
                "training wall time by goodput segment", ("segment",))
            self._ratio = self._registry.gauge(
                "tpu_goodput_ratio",
                "rolling productive-step fraction of wall time "
                f"(window {int(self._window_s)}s)")
            self._downtime = self._registry.histogram(
                "tpu_goodput_downtime_seconds",
                "reconfiguration downtime per recovery (exemplar: the "
                "recovery trace id)",
                buckets=(0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600))
        return self

    @property
    def started(self) -> bool:
        return self._started

    def stop(self) -> None:
        """Final accrual + flush (also the atexit hook for workers that
        exit via ``exit_for_reconfiguration``).  The trailing accrual
        happens only when this process actually measured: a
        supervisor-side tracker stopping after ``run_elastic`` returns
        must not dump the worker's whole (already-accounted) runtime
        into ``blocked``."""
        with self._mu:
            if not self._started:
                return
            if self._measured:
                self._accrue_locked(time.monotonic())
            self._flush_locked(force=True)

    # -- measurement -------------------------------------------------------
    def measure(self, segment: str):
        """Context manager attributing the enclosed wall time to
        ``segment``; no-op (shared instance, no allocation) before
        ``start()``.  Time between measurements accrues to ``blocked``."""
        if not self._started:
            return _NOOP_MEASURE
        if segment not in SEGMENTS:
            raise ValueError(f"unknown goodput segment {segment!r}; "
                             f"one of {SEGMENTS}")
        return _Measure(self, segment)

    def _enter(self, segment: str) -> None:
        with self._mu:
            self._measured = True
            self._accrue_locked(time.monotonic())
            self._stack.append(segment)

    def _exit(self, segment: str) -> None:
        with self._mu:
            self._accrue_locked(time.monotonic())
            if self._stack and self._stack[-1] == segment:
                self._stack.pop()
            self._flush_locked()

    def _accrue_locked(self, now: float) -> None:
        """Attribute [t_last, now) to the current segment (the stack
        top; ``blocked`` outside any scope)."""
        dt = now - self._t_last
        self._t_last = now
        if dt <= 0:
            return
        segment = self._stack[-1] if self._stack else SEG_BLOCKED
        self._local[segment] = self._local.get(segment, 0.0) + dt
        self._seconds.inc(segment, by=dt)
        self._window.append((now, segment, dt))
        cutoff = now - self._window_s
        while self._window and self._window[0][0] < cutoff:
            self._window.popleft()
        total = sum(d for _, _, d in self._window)
        if total > 0:
            self._ratio.set(sum(d for _, s, d in self._window
                                if s == SEG_STEP) / total)

    def record_downtime(self, duration_s: float, traceparent: str = "",
                        generation: Optional[int] = None) -> None:
        """Supervisor-side: attribute ``duration_s`` of worker absence to
        the ``reconfiguration`` segment, stamped with the recovery
        traceparent.  Emits the downtime span (parented on the recovery
        trace, so it lands in /debug/traces next to the controller's
        reconfigure span) and observes the downtime histogram with the
        recovery trace id as its exemplar."""
        if not self._started:
            self.start()
        record = {"at": time.time(), "duration_s": round(duration_s, 4),
                  "traceparent": traceparent, "generation": generation}
        ctx = SpanContext.from_traceparent(traceparent)
        with get_tracer().start_span(
                "goodput.reconfiguration_downtime",
                parent=traceparent or None,
                attributes={"duration_s": round(duration_s, 4),
                            "generation": generation}):
            # SAMPLED recovery traces only: an exemplar is the
            # documented metric→trace jump, and an unsampled ("-00")
            # traceparent's id resolves to nothing in /debug/traces —
            # advertising it would send an operator to an empty query
            self._downtime.observe(
                duration_s,
                exemplar={"trace_id": ctx.trace_id}
                if ctx is not None and ctx.sampled else None)
        with self._mu:
            # resync-then-add: the state file is authoritative (the
            # worker merged its segments into it right up to its death);
            # local deltas were folded in by the last flush, so reloading
            # cannot double count
            if self.state_path:
                merged = _load_state(self.state_path)
                self._baseline = dict(merged.get("totals", {}))
                self._baseline_records = list(
                    merged.get("reconfigurations", []))
            self._local[SEG_RECONFIGURATION] = \
                self._local.get(SEG_RECONFIGURATION, 0.0) + duration_s
            self._seconds.inc(SEG_RECONFIGURATION, by=duration_s)
            self._records.append(record)
            self._t_last = time.monotonic()
            self._flush_locked(force=True)

    # -- reporting ---------------------------------------------------------
    def totals(self) -> dict[str, float]:
        """Merged lifetime seconds per segment: the state file (the
        authoritative cross-process ledger — another process may have
        written since our last load) plus this process's un-flushed
        deltas.  The flush invariant makes this sound: ``_local`` holds
        ONLY what has never been folded into the file."""
        with self._mu:
            return self._merged_locked(reload=True)

    def _merged_locked(self, reload: bool = False) -> dict[str, float]:
        base = self._baseline
        if reload and self.state_path:
            fresh = _load_state(self.state_path).get("totals")
            if fresh:
                base = fresh
        out = dict(base)
        for seg, secs in self._local.items():
            out[seg] = out.get(seg, 0.0) + secs
        return out

    def ratio(self) -> float:
        """Lifetime goodput ratio: productive-step seconds over all
        accounted wall seconds (merged across reconfigurations)."""
        totals = self.totals()
        wall = sum(totals.values())
        return totals.get(SEG_STEP, 0.0) / wall if wall > 0 else 0.0

    def reconfigurations(self) -> list[dict]:
        with self._mu:
            base = self._baseline_records
            if self.state_path:
                fresh = _load_state(self.state_path).get(
                    "reconfigurations")
                if fresh is not None:
                    base = fresh
            return list(base) + list(self._records)

    def report(self) -> dict:
        totals = self.totals()
        return {
            "schema": _SCHEMA,
            "totals": {k: round(v, 4) for k, v in sorted(totals.items())},
            "wall_seconds": round(sum(totals.values()), 4),
            "goodput_ratio": round(self.ratio(), 4),
            "reconfigurations": self.reconfigurations(),
        }

    # -- state file --------------------------------------------------------
    def _flush_locked(self, force: bool = False) -> None:
        if not self.state_path:
            return
        now = time.monotonic()
        if not force and now - self._last_flush < self._flush_interval_s:
            return
        self._last_flush = now
        state = {
            "schema": _SCHEMA,
            "totals": {k: round(v, 6)
                       for k, v in sorted(self._merged_locked().items())},
            "reconfigurations": (list(self._baseline_records)
                                 + list(self._records)),
            "updated": time.time(),
        }
        # fold local into baseline so a later reload (record_downtime's
        # resync) sees exactly what the file holds
        self._baseline = {k: self._baseline.get(k, 0.0) + v
                          for k, v in self._local.items()} | {
            k: v for k, v in self._baseline.items()
            if k not in self._local}
        self._baseline_records.extend(self._records)
        self._local, self._records = {}, []
        _atomic_write(self.state_path, json.dumps(state, sort_keys=True))


def _atomic_write(path: str, data: str) -> None:
    """Write-then-rename: a reader never sees a torn file.  Not fsynced:
    the totals are rewritten at the next flush (the reference's
    ``atomic_write(..., durable=False)``)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        f.write(data)
    os.replace(tmp, path)


def _load_state(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return {}
    return data if isinstance(data, dict) else {}


# -- the process-default tracker (hook target) -----------------------------
# checkpointing.py / fit.py / the elastic supervisor instrument against
# THIS instance; it stays un-started (and therefore free) unless the
# workload opts in via start_from_env()/default_tracker().start()
_DEFAULT = GoodputTracker()
_DEFAULT_MU = threading.Lock()


def default_tracker() -> GoodputTracker:
    return _DEFAULT


def measure(segment: str):
    """Module-level hook: attribute the enclosed wall time to
    ``segment`` on the process-default tracker — a shared no-op until
    the workload opts in (zero-cost discipline)."""
    return _DEFAULT.measure(segment)


def start_from_env(env: Optional[dict] = None) -> Optional[GoodputTracker]:
    """Start the default tracker iff ``TPU_GOODPUT_FILE`` is set (the
    elastic supervisor injects it; operators can set it directly).
    Called from ``launcher.init_tpu_workload`` so every workload entry
    point inherits the hook without its own wiring.  Returns the tracker
    when started, None otherwise."""
    e = os.environ if env is None else env
    path = e.get(STATE_ENV, "")
    if not path:
        return None
    with _DEFAULT_MU:
        if not _DEFAULT.started:
            if _DEFAULT.state_path is None:
                _DEFAULT.state_path = path
            _DEFAULT.start()
            import atexit
            # exit_for_reconfiguration leaves through sys.exit: the
            # final accrual must still reach the state file or the
            # supervisor's merge loses the last partial window
            atexit.register(_DEFAULT.stop)
    return _DEFAULT
