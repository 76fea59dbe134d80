"""Multi-window SLO error-budget burn rates over the metrics registry,
copied from ``tpu_dra/workloads/slo.py``.

The registry's counters and histograms are *cumulative*; an SLO verdict
("is the error budget burning faster than the 99.9% target allows?")
needs *windowed* rates.  This module bridges the two without any
external TSDB: a :class:`SloTracker` snapshots (good, total) pairs on a
fixed cadence into a bounded ring and computes burn rates over the
standard multi-window set from the deltas — the same math a
Prometheus burn-rate alert would run, but answerable locally from
``/debug/slo`` on the serving process itself.

Definitions (Google SRE workbook ch. 5):

- error rate over window W:   ``bad_W / total_W``
- burn rate over window W:    ``error_rate_W / (1 - target)``
  (1.0 = exactly consuming budget at the sustainable pace; 14.4 over
  1h is the classic page threshold for a 99.9% / 30d SLO)

Objectives are (name, target, good_total_fn) where ``good_total_fn``
returns the cumulative ``(good, total)`` pair — e.g. non-5xx requests
over all requests, or histogram observations under the latency
threshold over all observations (:func:`histogram_under`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from tpu_dra_torch.util.metrics import Counter, Histogram

GoodTotalFn = Callable[[], tuple[float, float]]

# the multi-window set burn-rate alerting conventionally pairs: a fast
# window to catch cliffs, a medium one for sustained burn, a slow one
# approximating "how is the budget trending"
DEFAULT_WINDOWS_S = (60, 300, 1800)


class Objective:
    def __init__(self, name: str, target: float,
                 good_total: GoodTotalFn, description: str = "") -> None:
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got {target}")
        self.name = name
        self.target = target
        self.good_total = good_total
        self.description = description


def counter_good_total(counter: Counter,
                       is_bad: Callable[[tuple[str, ...]], bool]
                       ) -> GoodTotalFn:
    """(good, total) over a labeled counter: ``is_bad`` classifies each
    label tuple (e.g. ``code`` startswith "5")."""

    def fn() -> tuple[float, float]:
        good = total = 0.0
        for lv, val in counter.totals().items():
            total += val
            if not is_bad(lv):
                good += val
        return good, total

    return fn


def histogram_under(hist: Histogram, threshold: float) -> GoodTotalFn:
    """(observations <= threshold, all observations) across every label
    set of ``hist`` — the latency-SLO numerator straight from the
    cumulative bucket counts.  ``threshold`` must be (rounded up to) a
    bucket boundary; the tightest bucket <= threshold is used so the
    verdict is never optimistic."""
    idx = -1
    for i, b in enumerate(hist.buckets):
        if b <= threshold:
            idx = i
    if idx < 0:
        raise ValueError(
            f"threshold {threshold} is below the smallest bucket "
            f"{hist.buckets[0]} of {hist.name}")

    def fn() -> tuple[float, float]:
        good = total = 0.0
        for series in hist.snapshot().values():
            good += series["cumulative"][idx]
            total += series["count"]
        return good, total

    return fn


class SloTracker:
    """Snapshot (good, total) per objective on a cadence; serve
    multi-window burn rates from the ring.

    The ring spans ``max(windows) + one interval`` so the oldest window
    is always fully covered once warm; before that, the widest
    available span is used and reported via ``window_covered_s`` —
    a fresh process must answer honestly, not pretend an hour of
    history."""

    def __init__(self, objectives: list[Objective],
                 windows_s: tuple[int, ...] = DEFAULT_WINDOWS_S,
                 interval_s: float = 5.0) -> None:
        if not objectives:
            raise ValueError("SloTracker needs at least one objective")
        self.objectives = list(objectives)
        self.windows_s = tuple(sorted(windows_s))
        self.interval_s = interval_s
        keep = int(max(self.windows_s) / max(interval_s, 0.1)) + 2
        self._rings: dict[str, deque] = {
            o.name: deque(maxlen=keep) for o in self.objectives}
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling ----------------------------------------------------------
    def sample_now(self) -> None:
        """One snapshot per objective (the loop body; callable directly
        from tests and from scrape handlers that want fresh edges)."""
        now = time.monotonic()
        for obj in self.objectives:
            good, total = obj.good_total()
            with self._mu:
                self._rings[obj.name].append((now, good, total))

    def start(self) -> "SloTracker":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="slo-tracker")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        self.sample_now()
        while not self._stop.wait(self.interval_s):
            self.sample_now()

    # -- the verdict -------------------------------------------------------
    def burn_rates(self) -> dict:
        """Per-objective, per-window error rates and burn rates — the
        /debug/slo payload.

        The CURRENT edge is read fresh but NOT stored: the ring is
        sized for the loop cadence, and request-driven appends (a
        dashboard polling /debug/slo) would silently push old samples
        out and shrink the span the slow window actually covers while
        still labeling it "1800s"."""
        out: dict = {"windows_s": list(self.windows_s), "objectives": {}}
        for obj in self.objectives:
            good_now, total_now = obj.good_total()
            now = time.monotonic()
            with self._mu:
                ring = list(self._rings[obj.name])
            if not ring:
                ring = [(now, good_now, total_now)]
            windows = {}
            for w in self.windows_s:
                # oldest sample still inside the window; a cold ring
                # degrades to the widest span it has
                base = ring[0]
                for s in ring:
                    if s[0] >= now - w:
                        base = s
                        break
                t0, good0, total0 = base
                total_w = total_now - total0
                bad_w = (total_now - good_now) - (total0 - good0)
                err = bad_w / total_w if total_w > 0 else 0.0
                windows[f"{w}s"] = {
                    "total": total_w,
                    "bad": bad_w,
                    "error_rate": round(err, 6),
                    "burn_rate": round(err / (1.0 - obj.target), 3),
                    "window_covered_s": round(now - t0, 1),
                }
            out["objectives"][obj.name] = {
                "target": obj.target,
                "description": obj.description,
                "lifetime": {
                    "total": total_now,
                    "bad": total_now - good_now,
                    "error_rate": round(
                        (total_now - good_now) / total_now, 6)
                    if total_now > 0 else 0.0,
                },
                "windows": windows,
            }
        return out
