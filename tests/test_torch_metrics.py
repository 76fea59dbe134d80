"""The port's copy of the Prometheus metrics (tpu_dra_torch/util/metrics.py)
against the reference module (tpu_dra/util/metrics.py): the same call
sequences give byte-equal plain text expositions, the same registry
rules and the same label bounding."""

from __future__ import annotations

import threading

import pytest

from tpu_dra.util import metrics as jm
from tpu_dra.workloads.serve import ServeMetrics as JaxServeMetrics
from tpu_dra_torch.util import metrics as tm
from tpu_dra_torch.workloads.serve import ServeMetrics


def counters(m):
    reg = m.Registry()
    c = reg.counter("t_requests_total", "requests", ("path", "code"))
    c.inc("/a", "200")
    c.inc("/a", "200", by=2.5)
    c.inc("/b", "503")
    reg.counter("t_plain_total", "an unlabeled counter").inc(by=7)
    return reg


def gauges(m):
    reg = m.Registry()
    g = reg.gauge("t_depth", "queue depth", ("queue",))
    g.set(3.0, "x")
    g.set(1.5, "y")
    g.inc("x", by=2)
    reg.gauge("t_up", "up").set(1)
    return reg


def histograms(m):
    reg = m.Registry()
    h = reg.histogram("lat", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    hl = reg.histogram("t_lat_seconds", "labeled", buckets=(0.01, 0.1, 1),
                       labels=("path", "tenant"))
    for v, p, t in ((0.005, "/g", "a"), (0.2, "/g", "a"), (3, "/s", "b"),
                    (0.01, "/g", "a")):
        hl.observe(v, p, t)
    reg.histogram("t_empty_seconds", "never observed")
    return reg


def escapes(m):
    reg = m.Registry()
    c = reg.counter("t_esc_total", 'help with \\ and\nnewline "quoted"',
                    ("v",))
    c.inc('a"b\\c\nd')
    return reg


def serve_metrics(serve_metrics_cls):
    """The serving front end's whole registry after a few requests."""
    sm = serve_metrics_cls()
    sm.observe("/generate", 200, 0.3, tokens=12, tenant="acme")
    sm.observe("/generate", 503, 0.001, tenant="default")
    sm.observe("/stream", 504, 2.0, tokens=3, tenant="acme")
    sm.ttft.observe(0.04, "acme")
    sm.itl.observe(0.007, "acme")
    sm.shed.inc("queue_full")
    sm.shed.inc("deadline_expired")
    return sm.registry


SCRIPTS = {"counters": counters, "gauges": gauges,
           "histograms": histograms, "escapes": escapes}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_plain_exposition_is_byte_equal(name):
    want = SCRIPTS[name](jm).expose()
    got = SCRIPTS[name](tm).expose()
    assert got == want


def test_serve_metrics_exposition_is_byte_equal():
    """Same names, labels, buckets and HELP texts as the reference
    server's: a dashboard or the router reads both alike."""
    assert serve_metrics(ServeMetrics).expose() == \
        serve_metrics(JaxServeMetrics).expose()


def test_histogram_plain_exposition_lines():
    """tests/test_metrics.py :383, on the port's copy."""
    text = histograms(tm).expose()
    assert 'lat_bucket{le="0.1"} 1' in text
    assert 'lat_bucket{le="1.0"} 2' in text
    assert 'lat_bucket{le="+Inf"} 3' in text
    assert "lat_count 3" in text and "lat_sum 5.55" in text
    assert "# {" not in text and "# EOF" not in text


def test_negotiation_answers_plain_text():
    reg = histograms(tm)
    for accept in ("", "application/openmetrics-text", "text/plain"):
        body, ctype = tm.negotiate_exposition(accept, reg)
        assert body == reg.expose()
        assert ctype == jm.TEXT_CONTENT_TYPE


@pytest.mark.parametrize("m", [jm, tm], ids=["reference", "port"])
def test_registry_rules(m):
    reg = m.Registry()
    c = reg.counter("t_total", "t", ("a",))
    assert reg.counter("t_total", "t", ("a",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("t_total", "t", ("a",))
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("t_total", "other help", ("a",))
    with pytest.raises(ValueError, match="strictly increasing"):
        m.Histogram("t_bad", "t", buckets=(0.1, 0.1, 1.0))


@pytest.mark.parametrize("kw", [
    dict(raw="/generate", allowed=frozenset({"/generate"})),
    dict(raw="/nope", allowed=frozenset({"/generate"})),
    dict(raw=None), dict(raw=""), dict(raw="x" * 500),
    dict(raw="~overflow~"), dict(raw="a~b"),
], ids=["allowed", "outside", "none", "empty", "long", "sentinel", "tilde"])
def test_bounded_label_matches_reference(kw):
    assert tm.bounded_label(**kw) == jm.bounded_label(**kw)


def test_bounded_label_first_come_cap():
    seen_j, seen_t = set(), set()
    for i in range(8):
        v = f"t{i}"
        assert tm.bounded_label(v, seen=seen_t, cap=5, overflow="o") == \
            jm.bounded_label(v, seen=seen_j, cap=5, overflow="o")
    assert seen_t == seen_j and len(seen_t) == 5


def test_tenant_cardinality_capped():
    """tests/test_serve.py :828 on the port's ServeMetrics."""
    m = ServeMetrics()
    assert m.tenant_label("acme") == "acme"
    assert m.tenant_label("") == "default"
    for i in range(ServeMetrics.MAX_TENANTS + 20):
        m.tenant_label(f"tenant-{i}")
    assert m.tenant_label("one-more") == ServeMetrics.OVERFLOW_TENANT
    assert m.tenant_label("acme") == "acme"
    assert len(m.tenant_label("x" * 500)) <= 64
    assert ServeMetrics().tenant_label(ServeMetrics.OVERFLOW_TENANT) != \
        ServeMetrics.OVERFLOW_TENANT


def test_counts_exact_across_threads_and_thread_death():
    """Per-thread cells: increments and observations from many threads
    (each gone before the read) all count."""
    reg = tm.Registry()
    c = reg.counter("t_total", "t", ("k",))
    h = reg.histogram("t_seconds", "t", buckets=(0.5,))

    def work():
        for _ in range(500):
            c.inc("x")
            h.observe(0.25)
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value("x") == 4000.0
    assert h.snapshot()[()]["count"] == 4000
    assert c.value("x") == 4000.0            # the dead cells folded once
    assert len(c._cells._cells) == 0


def exemplar_script(m, trace):
    """Observations with explicit exemplars, inside sampled spans of the
    package's own tracer (the ambient exemplar), inside an unsampled one
    (none), and a counter family for the OpenMetrics ``_total`` rule."""
    reg = m.Registry()
    h = reg.histogram("t_lat_seconds", "labeled", buckets=(0.01, 0.1, 1),
                      labels=("path", "tenant"))
    h.observe(0.005, "/g", "a", exemplar={"trace_id": "11" * 16})
    h.observe(0.05, "/g", "a", exemplar={"trace_id": "22" * 16,
                                         "span_id": "33" * 8})
    with trace.Tracer().start_span(
            "r", parent="00-" + "44" * 16 + "-" + "55" * 8 + "-01"):
        h.observe(0.5, "/g", "a")
        h.observe(7.0, "/s", "b")
    with trace.Tracer().start_span(
            "r", parent="00-" + "66" * 16 + "-" + "55" * 8 + "-00"):
        h.observe(0.07, "/s", "b")
    h.observe(0.006, "/g", "a", exemplar={"trace_id": "77" * 16})
    reg.histogram("t_plain_seconds", "no exemplars").observe(0.2)
    reg.counter("t_requests_total", "requests", ("code",)).inc("200")
    reg.gauge("t_up", "up").set(1)
    return reg


def test_exemplar_exposition_is_byte_equal(monkeypatch):
    """The same observations under one clock: the OpenMetrics text with
    its exemplars, and the plain text without them, byte-equal to the
    reference's; negotiation answers alike."""
    import time

    import tpu_dra.trace as jtrace
    import tpu_dra_torch.trace as ttrace
    monkeypatch.setattr(time, "time", lambda: 1700000000.123456)
    want = exemplar_script(jm, jtrace)
    got = exemplar_script(tm, ttrace)
    assert got.expose(openmetrics=True) == want.expose(openmetrics=True)
    assert got.expose() == want.expose()
    assert got.has_exemplars() and want.has_exemplars()
    om = got.expose(openmetrics=True)
    assert '# {trace_id="' + "44" * 16 + '"} 0.5 1700000000.123' in om
    assert "66" * 16 not in om and om.endswith("# EOF\n")
    assert "# TYPE t_requests counter" in om
    for accept in ("", "application/openmetrics-text", "text/plain"):
        assert tm.negotiate_exposition(accept, got) == \
            jm.negotiate_exposition(accept, want)
    with pytest.raises(ValueError, match="exemplar labels"):
        got.histogram("t_lat_seconds", "labeled", buckets=(0.01, 0.1, 1),
                      labels=("path", "tenant")).observe(
            0.1, "/g", "a", exemplar={"user": "x"})


def test_exemplars_survive_thread_death_newest_wins(monkeypatch):
    """Exemplar cells fold like the counts: an exemplar written by a dead
    thread stays, and the newest exemplar of a bucket wins."""
    import time
    reg = tm.Registry()
    h = reg.histogram("t_seconds", "t", buckets=(1.0,))
    clock = iter([10.0, 20.0, 30.0])
    monkeypatch.setattr(time, "time", lambda: next(clock))
    for tid in ("aa", "bb"):
        t = threading.Thread(target=h.observe, args=(0.5,),
                             kwargs={"exemplar": {"trace_id": tid * 16}})
        t.start()
        t.join(10)
        assert not t.is_alive()
    h.observe(0.5, exemplar={"trace_id": "cc" * 16})
    om = reg.expose(openmetrics=True)
    assert 'le="1.0"} 3 # {trace_id="' + "cc" * 16 + '"} 0.5 30.0' in om
