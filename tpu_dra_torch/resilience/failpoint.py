"""Named failpoints, copied from ``tpu_dra/resilience/failpoint.py``: the
part the serving path uses.

Code declares injection points at import time::

    from tpu_dra_torch.resilience import failpoint
    failpoint.register("serve.engine.slow_decode", "what it widens")
    ...
    failpoint.hit("serve.engine.slow_decode")

``hit`` is a no-op — one read of a module-global flag, no lock — unless
an activation is armed.  Tests arm and disarm them::

    failpoint.activate("serve.engine.slow_decode=sleep(150)")
    failpoint.reset()

Action grammar (an optional ``N*`` prefix fires the action at most N
times)::

    sleep(250)       block 250 ms on the calling thread (default 100)
    error            raise FailpointError
    error(ExcName)   raise the builtin exception ExcName

The reference's ``crash`` and ``stall`` actions and its environment and
plan-file activation are not copied: no serving test of the port arms
them.
"""

from __future__ import annotations

import builtins
import re
import threading
import time
from dataclasses import dataclass
from typing import Optional

_TERM_RE = re.compile(
    r"^(?P<name>[a-zA-Z0-9_.\-]+)="
    r"(?:(?P<count>\d+)\*)?"
    r"(?P<action>[a-z]+)"
    r"(?:\((?P<arg>[^)]*)\))?$")

_ACTIONS = ("error", "sleep")


class FailpointError(RuntimeError):
    """Default exception for ``error`` actions with no explicit type."""


@dataclass(frozen=True)
class Failpoint:
    """One registered injection point (the catalog entry)."""

    name: str
    doc: str


@dataclass
class _Activation:
    action: str
    arg: str = ""
    remaining: Optional[int] = None     # None = unlimited


_mu = threading.Lock()
_registry: dict[str, Failpoint] = {}        # guarded by _mu
_active: dict[str, _Activation] = {}        # guarded by _mu
# the disarmed fast path: hit() reads this one flag and returns
_armed = False


def register(name: str, doc: str = "") -> Failpoint:
    """Declare an injection point.  Idempotent for identical metadata;
    two different points must not share a name."""
    fp = Failpoint(name=name, doc=doc)
    with _mu:
        existing = _registry.get(name)
        if existing is not None and existing != fp:
            raise ValueError(f"failpoint {name!r} already registered "
                             f"with different metadata")
        _registry[name] = fp
    return fp


def registered() -> list[Failpoint]:
    """The catalog, sorted by name."""
    with _mu:
        return sorted(_registry.values(), key=lambda f: f.name)


def parse_spec(spec: str) -> dict[str, _Activation]:
    """Parse ``name=action[;name=action...]`` (``;`` or ``,``
    separated).  Raises ValueError on malformed terms: a typo'd fault
    plan must fail loudly, not silently inject nothing."""
    out: dict[str, _Activation] = {}
    for raw in re.split(r"[;,\n]", spec):
        term = raw.split("#", 1)[0].strip()
        if not term:
            continue
        m = _TERM_RE.match(term)
        if m is None:
            raise ValueError(f"malformed failpoint term {term!r} "
                             f"(want name=[N*]action[(arg)])")
        action = m.group("action")
        if action not in _ACTIONS:
            raise ValueError(f"unknown failpoint action {action!r} in "
                             f"{term!r} (known: {', '.join(_ACTIONS)})")
        count = m.group("count")
        out[m.group("name")] = _Activation(
            action=action, arg=m.group("arg") or "",
            remaining=int(count) if count else None)
    return out


def activate(spec: str) -> None:
    """Arm the terms in ``spec``; replaces the current activation set."""
    global _armed
    acts = parse_spec(spec)
    with _mu:
        _active.clear()
        _active.update(acts)
        _armed = bool(_active)


def reset() -> None:
    """Disarm everything (test teardown)."""
    global _armed
    with _mu:
        _active.clear()
        _armed = False


def _resolve_exc(name: str) -> type[BaseException]:
    if not name:
        return FailpointError
    exc = getattr(builtins, name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    raise ValueError(f"failpoint error type {name!r} is not a builtin "
                     f"exception")


def hit(name: str) -> None:
    """Fire the failpoint ``name`` if an activation targets it, on the
    calling thread: ``error`` raises, ``sleep`` blocks."""
    if not _armed:
        return
    with _mu:
        act = _active.get(name)
        if act is None:
            return
        if act.remaining is not None:
            if act.remaining <= 0:
                return
            act.remaining -= 1
        action, arg = act.action, act.arg
    if action == "error":
        raise _resolve_exc(arg)(f"failpoint {name}")
    time.sleep((float(arg) if arg else 100.0) / 1000.0)
