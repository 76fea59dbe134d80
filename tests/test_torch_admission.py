"""The port's copy of the admission gate (tpu_dra_torch/workloads/
admission.py) against the reference module (tpu_dra/workloads/
admission.py): the same call sequences, under one injected clock, give
the same admissions, the same typed sheds with the same Retry-After,
and the same /debug/overload snapshots."""

from __future__ import annotations

import threading
import types

import pytest

from tpu_dra.workloads import admission as ja
from tpu_dra_torch.workloads import admission as ta


class Clock:
    """A monotonic clock that moves only when told to."""

    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


def run(module, script, clock, **ctl_kw):
    """Play ``script`` against a fresh controller of ``module``; the
    outcome of every step."""
    ctl = module.AdmissionController(**ctl_kw)
    tickets, out = [], []
    for op, *args in script:
        if op == "acq":
            try:
                tickets.append(ctl.acquire(*args))
                out.append(("ok", tickets[-1].tenant, tickets[-1].cost))
            except module.ShedError as exc:
                out.append(("shed", exc.reason, exc.retry_after_s,
                            str(exc)))
        elif op == "rel":
            ctl.release(tickets[args[0]], completed=args[1])
        elif op == "tick":
            clock.now += args[0]
        elif op == "drain":
            ctl.begin_drain()
            out.append(("draining", ctl.draining))
        elif op == "record":
            ctl.record_shed(args[0])
        elif op == "snap":
            out.append(("snap", ctl.snapshot()))
    return out


def warm(n, cost=10, dt=0.1):
    """``n`` requests admitted and completed ``dt`` apart: a live drain
    rate for Retry-After."""
    script = []
    for i in range(n):
        script += [("acq", "t", cost), ("tick", dt), ("rel", i, True)]
    return script


SCENARIOS = {
    "queue_full": (dict(max_cost=100, burst_fraction=1.0), [
        ("acq", "t", 40), ("acq", "t", 40), ("acq", "t", 40),
        ("rel", 0, True), ("acq", "t", 40), ("snap",)]),
    "cost_too_large": (dict(max_cost=100), [
        ("acq", "t", 101), ("acq", "t", 0), ("snap",)]),
    "fair_share": (dict(max_cost=100, burst_fraction=0.7), [
        *[("acq", "flood", 10)] * 8, ("acq", "polite", 10),
        ("acq", "flood", 10), ("acq", "polite", 40), ("snap",)]),
    "single_tenant": (dict(max_cost=100, burst_fraction=0.7), [
        *[("acq", "only", 10)] * 8, ("snap",)]),
    "retry_after_from_drain_rate": (dict(max_cost=100, burst_fraction=1.0),
                                    [*warm(20), ("acq", "t", 90),
                                     ("acq", "t", 50), ("tick", 3.0),
                                     ("acq", "t", 50), ("tick", 60.0),
                                     ("acq", "t", 50), ("snap",)]),
    "cold_start_retry": (dict(max_cost=10), [
        ("acq", "t", 10), ("acq", "t", 5)]),
    "drain": (dict(max_cost=100, drain_grace_s=7.0), [
        ("acq", "t", 10), ("drain",), ("acq", "t", 1), ("acq", "u", 1),
        ("rel", 0, True), ("snap",)]),
    "release_idempotent": (dict(max_cost=100), [
        ("acq", "t", 50), ("rel", 0, False), ("rel", 0, False), ("snap",),
        ("acq", "t", 50), ("tick", 1.0), ("rel", 1, True), ("snap",)]),
    "snapshot_shape": (dict(max_cost=64), [
        ("acq", "a", 10), ("record", "queue_full"),
        ("record", "deadline_expired"), ("snap",)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_decisions_as_the_reference(name, monkeypatch):
    kw, script = SCENARIOS[name]
    outs = []
    for module in (ja, ta):
        clock = Clock()
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            monotonic=clock.monotonic))
        outs.append(run(module, script, clock, **kw))
    assert outs[1] == outs[0]
    # each scenario but the bookkeeping ones reaches a shed
    assert any(o[0] == "shed" for o in outs[0]) == (
        name not in ("release_idempotent", "snapshot_shape"))


def test_retry_after_tracks_the_rate(monkeypatch):
    """tests/test_admission.py :82: a warm drain rate gives a small valid
    integer, neither the cold 1 nor the clamp."""
    kw, script = SCENARIOS["retry_after_from_drain_rate"]
    clock = Clock()
    monkeypatch.setattr(ta, "time", types.SimpleNamespace(
        monotonic=clock.monotonic))
    out = run(ta, script, clock, **kw)
    sheds = [o for o in out if o[0] == "shed"]
    assert sheds and all(1 <= s[2] <= 30 for s in sheds)
    assert sheds[0][1] == "queue_full"


@pytest.mark.parametrize("rows,steps", [
    ([[1, 2, 3]], 16), ([[1], [2, 3]], 4), ([], 16), (None, 16),
    ([[1]], 0), ([[1, 2]], "x"), ("abc", 3)])
def test_request_cost_matches(rows, steps):
    try:
        want = ja.request_cost(rows, steps)
    except (TypeError, ValueError) as exc:
        with pytest.raises(type(exc)):
            ta.request_cost(rows, steps)
        return
    assert ta.request_cost(rows, steps) == want


@pytest.mark.parametrize("raw", ["250", "", None, "abc", "-5", "0", "inf",
                                 "nan", "1e3", " 40 "])
def test_parse_deadline_ms_matches(raw):
    assert ta.parse_deadline_ms(raw) == ja.parse_deadline_ms(raw)


def test_shed_vocabulary_matches():
    assert ta.SHED_REASONS == ja.SHED_REASONS
    assert (ta.REASON_DEADLINE, ta.REASON_DRAINING) == \
        (ja.REASON_DEADLINE, ja.REASON_DRAINING)


def test_drain_waits_for_every_ticket():
    """tests/test_admission.py :107 on the port's copy, on the real
    clock: wait_idle blocks on an outstanding ticket, then returns."""
    ctl = ta.AdmissionController(100, drain_grace_s=7.0)
    t = ctl.acquire("t", 10)
    ctl.begin_drain()
    assert ctl.wait_idle(timeout=0.05) is False
    threading.Timer(0.05, lambda: ctl.release(t)).start()
    assert ctl.wait_idle(timeout=5.0) is True
    ctl.begin_drain()
    assert ctl.wait_idle(timeout=0.1) is True


def test_concurrent_acquire_release_conserves_cost():
    ctl = ta.AdmissionController(10_000)
    errs: list[BaseException] = []

    def worker(seed: int) -> None:
        try:
            for i in range(200):
                t = ctl.acquire(f"t{seed % 4}", (i % 7) + 1)
                ctl.release(t, completed=i % 2 == 0)
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs
    snap = ctl.snapshot()
    assert snap["outstanding_cost"] == 0 and snap["outstanding_by_tenant"] == {}
    assert snap["admitted_total"] == snap["released_total"] == 1600
