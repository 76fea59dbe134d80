"""Runtime recapture ratchet, ported from
``tpu_dra/workloads/retrace_guard.py``.

The reference counts the compiles of its jitted programs through
``_cache_size()`` deltas, so a retrace that slips past its static
checker shows up as a nonzero ``recompiles_since_mark`` in the engine's
``stats()`` (its bench gate ``engine_decode_recompiles`` pins it at 0).
PyTorch runs eagerly; the port's counterpart of a compiled program is a
captured CUDA graph, and the engine's graphed programs
(``continuous._GraphedProgram``, in the engine's ``_graphs`` dict) each
expose ``_cache_size()``, the number of times that program was captured.
A capture after warmup (a new key, or static tensors that moved, such
as weights replaced instead of copied in place) is this guard's
finding.

Design constraints, as in the reference:

* **Off by default, free when off.**  Serving hot paths call
  ``recompiles_since_mark()`` indirectly through ``stats()``; when the
  guard is disabled every method is a single attribute test.
* **Discovery, not registration.**  Programs are captured lazily and
  land in dict attributes as traffic arrives, so the guard re-scans its
  attached objects on every ``counts()`` call; a callable counts iff it
  exposes a callable ``_cache_size``.
* **Marks, not absolutes.**  Warmup captures are the point of warmup;
  ``ContinuousEngine.warmup`` calls ``mark()`` after its burst so the
  steady-state counter starts at zero and any later capture is a
  finding.

Enable with ``TPU_DRA_RETRACE_GUARD=1`` (any value but ``0``/``false``/
``no``/empty) or construct with ``RetraceGuard(enabled=True)``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Tuple

ENV_FLAG = "TPU_DRA_RETRACE_GUARD"

__all__ = ["ENV_FLAG", "RetraceGuard", "cache_size_of"]


def cache_size_of(fn: Any) -> "int | None":
    """The capture (cache entry) count of ``fn``, or None when ``fn``
    exposes no ``_cache_size`` probe or the probe errors — the guard
    must never take the serving loop down."""
    probe = getattr(fn, "_cache_size", None)
    if not callable(probe):
        return None
    try:
        return int(probe())
    except (TypeError, ValueError):
        # not a zero-arg int probe — some unrelated attr happens to be
        # named _cache_size; treat as "not a program"
        return None


def _env_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "").strip().lower() not in (
        "", "0", "false", "no")


class RetraceGuard:
    """Counts captures across a set of attached objects' programs.

    ``attach(label, obj)`` records an object root; every ``counts()``
    re-scans its instance attributes — direct programs and dict-valued
    attributes whose values are programs (the engine's lazy ``_graphs``)
    — so programs captured after attach are discovered automatically.  ``watch(label, fn)`` pins a single
    callable that isn't reachable from any attached object.
    """

    def __init__(self, enabled: "bool | None" = None) -> None:
        self.enabled = _env_enabled() if enabled is None else bool(enabled)
        self._objs: List[Tuple[str, Any]] = []
        self._fns: List[Tuple[str, Any]] = []
        self._marked: Dict[str, int] = {}
        self._has_mark = False

    # -- wiring ------------------------------------------------------------

    def attach(self, label: str, obj: Any) -> None:
        """Scan ``obj`` (now and on every poll) for programs."""
        if not self.enabled:
            return
        self._objs.append((label, obj))

    def watch(self, label: str, fn: Any) -> None:
        """Pin one callable the attribute scan can't reach."""
        if not self.enabled:
            return
        self._fns.append((label, fn))

    # -- discovery ---------------------------------------------------------

    def _iter_live(self) -> Iterator[Tuple[str, Any]]:
        for label, fn in self._fns:
            yield label, fn
        for root, obj in self._objs:
            attrs = getattr(obj, "__dict__", None)
            if not isinstance(attrs, dict):
                continue
            for name, value in list(attrs.items()):
                if cache_size_of(value) is not None:
                    yield f"{root}.{name}", value
                elif isinstance(value, dict):
                    for key, member in list(value.items()):
                        if cache_size_of(member) is not None:
                            yield f"{root}.{name}[{key!r}]", member

    def counts(self) -> Dict[str, int]:
        """label -> current capture count, freshly discovered."""
        if not self.enabled:
            return {}
        out: Dict[str, int] = {}
        for label, fn in self._iter_live():
            size = cache_size_of(fn)
            if size is not None:
                out[label] = size
        return out

    # -- the ratchet -------------------------------------------------------

    def mark(self) -> None:
        """Snapshot current counts; captures before a mark are expected
        (warmup), captures after it are findings."""
        if not self.enabled:
            return
        self._marked = self.counts()
        self._has_mark = True

    def recompiles_since_mark(self) -> int:
        """Total NEW captures since ``mark()`` — growth on every known
        program plus the full count of programs that appeared after the
        mark (a lazily captured program that first fires post-warmup is
        itself a post-warmup capture).  0 before any mark: warmup
        captures are not findings."""
        if not self.enabled or not self._has_mark:
            return 0
        total = 0
        for label, size in self.counts().items():
            total += max(0, size - self._marked.get(label, 0))
        return total

    def total_entries(self) -> int:
        """Sum of all live capture counts (volume, not delta)."""
        if not self.enabled:
            return 0
        return sum(self.counts().values())

    def tracked(self) -> int:
        """How many programs discovery currently sees."""
        if not self.enabled:
            return 0
        return len(self.counts())

    def stats(self) -> Dict[str, int]:
        """The fields the engine merges into its ``stats()`` dict when
        the guard is on (the reference's keys)."""
        if not self.enabled:
            return {}
        counts = self.counts()
        since = 0
        if self._has_mark:
            for label, size in counts.items():
                since += max(0, size - self._marked.get(label, 0))
        return {
            "recompiles_since_mark": since,
            "compile_cache_entries": sum(counts.values()),
            "jit_callables_tracked": len(counts),
        }
