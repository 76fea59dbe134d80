"""The port's copy of the SLO burn rates (tpu_dra_torch/workloads/slo.py)
against the reference module (tpu_dra/workloads/slo.py): each server's
own ServeMetrics fed the same requests, under one injected clock, give
the same /debug/slo payload."""

from __future__ import annotations

import types

import pytest

from tpu_dra.workloads import slo as jslo
from tpu_dra.workloads.serve import ServeMetrics as JaxServeMetrics
from tpu_dra_torch.util.metrics import Registry
from tpu_dra_torch.workloads import slo as tslo
from tpu_dra_torch.workloads.serve import ServeMetrics


def availability_is_bad(lv):
    """The servers' classifier: 5xx burns the budget, 504 (a client's
    deadline) does not."""
    return lv[1].startswith("5") and lv[1] != "504"


def tracker(slo, metrics, windows=(60, 300, 1800)):
    return slo.SloTracker([
        slo.Objective("availability", 0.999, slo.counter_good_total(
            metrics.requests, is_bad=availability_is_bad),
            description="non-5xx"),
        slo.Objective("latency", 0.99,
                      slo.histogram_under(metrics.latency, 1.0),
                      description="under 1s"),
    ], windows_s=windows, interval_s=1000.0)   # sampled by hand


def traffic(m, kind):
    """One phase of requests into ServeMetrics ``m``."""
    if kind == "ok":
        for i in range(90):
            m.observe("/generate", 200, 0.01 * (i % 5 + 1), tenant="a")
    elif kind == "shed":
        for _ in range(10):
            m.observe("/generate", 503, 0.002)
            m.shed.inc("queue_full")
    elif kind == "deadline":
        for _ in range(5):
            m.observe("/generate", 504, 0.3)
            m.shed.inc("deadline_expired")
    elif kind == "slow":
        for _ in range(7):
            m.observe("/stream", 200, 2.5, tenant="b")
    elif kind == "error":
        m.observe("/generate", 500, 0.01)


# (steps: a traffic kind, "sample", or a clock advance in seconds)
SCRIPTS = {
    "shed_503s_burn": ["ok", "sample", "shed", "ok"],
    "deadline_504s_do_not_burn": ["sample", "ok", "deadline", "error"],
    "latency_objective": ["ok", "sample", "slow", "ok"],
    "windows_age_out": ["ok", "sample", 100.0, "shed", "sample", 400.0,
                        "slow", "sample", 30.0, "error"],
    "cold_ring": ["ok"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_burn_rates_match_the_reference(name, monkeypatch):
    outs = []
    for slo, metrics_cls in ((jslo, JaxServeMetrics), (tslo, ServeMetrics)):
        clock = types.SimpleNamespace(now=5000.0)
        monkeypatch.setattr(slo, "time", types.SimpleNamespace(
            monotonic=lambda c=clock: c.now))
        m = metrics_cls()
        tr = tracker(slo, m)
        for step in SCRIPTS[name]:
            if step == "sample":
                tr.sample_now()
            elif isinstance(step, float):
                clock.now += step
            else:
                traffic(m, step)
        outs.append(tr.burn_rates())
    assert outs[1] == outs[0]


def test_shed_503s_burn_and_504s_do_not():
    """tests/test_slo.py :120, :149 on the port's copy."""
    m = ServeMetrics()
    tr = tracker(tslo, m, windows=(60,))
    traffic(m, "ok")
    tr.sample_now()
    traffic(m, "shed")
    traffic(m, "deadline")
    win = tr.burn_rates()["objectives"]["availability"]["windows"]["60s"]
    assert win["bad"] == 10.0 and win["total"] == 15.0
    assert m.shed.value("deadline_expired") == 5.0


def test_objective_and_histogram_rules():
    with pytest.raises(ValueError, match="target"):
        tslo.Objective("bad", 1.0, lambda: (0, 0))
    h = Registry().histogram("t_lat_seconds", "t", buckets=(0.1, 0.25, 1.0))
    for v in (0.05, 0.2, 0.2, 0.9, 5.0):
        h.observe(v)
    assert tslo.histogram_under(h, 0.5)() == (3, 5)   # rounds down
    with pytest.raises(ValueError, match="below the smallest bucket"):
        tslo.histogram_under(h, 0.01)


def test_tracker_thread_start_stop():
    tr = tslo.SloTracker([tslo.Objective("a", 0.9, lambda: (1.0, 1.0))],
                         interval_s=0.05).start()
    try:
        assert "a" in tr.burn_rates()["objectives"]
    finally:
        tr.stop()
