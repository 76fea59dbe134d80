"""The port's copy of the tracer (tpu_dra_torch/trace) against the
reference package (tpu_dra/trace): the same ``traceparent`` strings parse
to the same contexts and format back alike, head sampling decides alike,
the same spans render to the same Chrome trace JSON, and
``debug_traces_body`` answers the same filters with the same codes and
bodies.  Exact equality throughout: the module is a copy."""

from __future__ import annotations

import json

import pytest

import tpu_dra.trace as jt
import tpu_dra_torch.trace as tt
from tpu_dra.trace import export as jexport
from tpu_dra.trace import propagation as jprop
from tpu_dra.trace import tracer as jtracer
from tpu_dra_torch.trace import export as texport
from tpu_dra_torch.trace import propagation as tprop
from tpu_dra_torch.trace import tracer as ttracer

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
SPAN = "00f067aa0ba902b7"

HEADERS = [
    f"00-{TRACE}-{SPAN}-01", f"00-{TRACE}-{SPAN}-00",
    f"  00-{TRACE}-{SPAN}-01 ", f"01-{TRACE}-{SPAN}-01-extra",
    f"00-{TRACE}-{SPAN}-01-extra", f"ff-{TRACE}-{SPAN}-01",
    f"00-{'0' * 32}-{SPAN}-01", f"00-{TRACE}-{'0' * 16}-01",
    f"00-{TRACE.upper()}-{SPAN}-01", f"00-{TRACE[:-1]}-{SPAN}-01",
    f"00-{TRACE}-{SPAN}-1", f"00-{TRACE}-{SPAN}-03", f"0-{TRACE}-{SPAN}-01",
    "", None, "garbage", 17, f"00-{TRACE}-{SPAN}",
]


@pytest.mark.parametrize("header", HEADERS, ids=range(len(HEADERS)))
def test_traceparent_parse_and_format(header):
    want = jt.SpanContext.from_traceparent(header)
    got = tt.SpanContext.from_traceparent(header)
    if want is None:
        assert got is None
        return
    assert (got.trace_id, got.span_id, got.sampled) == \
        (want.trace_id, want.span_id, want.sampled)
    assert got.to_traceparent() == want.to_traceparent()


@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5, 0.999, 1.0])
def test_head_sampling_decides_alike(ratio):
    ids = [f"{i * 0x0fedcba9 % (1 << 32):08x}" + "0" * 24
           for i in range(200)]
    assert [ttracer._head_sampled(t, ratio) for t in ids] == \
        [jtracer._head_sampled(t, ratio) for t in ids]


def test_noop_span_for_unsampled_parents_and_ratio_zero():
    for mod in (jt, tt):
        tracer = mod.Tracer(sample_ratio=0.0)
        with tracer.start_span("x") as span:
            assert span is mod.NOOP_SPAN
            assert mod.current_traceparent().endswith("-00")
        with mod.Tracer().start_span(
                "y", parent=f"00-{TRACE}-{SPAN}-00") as span:
            assert span is mod.NOOP_SPAN
        assert mod.current_span() is None


def test_child_spans_parent_through_the_contextvar():
    ring = texport.RingBufferExporter(16)
    tracer = tt.Tracer(service="svc", exporters=(ring,))
    with tracer.start_span("outer", parent=f"00-{TRACE}-{SPAN}-01") as a:
        with tracer.start_span("inner") as b:
            assert tt.current_ids() == (TRACE, b.context.span_id)
            assert tt.current_traceparent() == b.context.to_traceparent()
    spans = {s["name"]: s for s in ring.spans()}
    assert spans["outer"]["parent_id"] == SPAN
    assert spans["inner"]["parent_id"] == a.context.span_id
    assert {s["trace_id"] for s in spans.values()} == {TRACE}
    with pytest.raises(RuntimeError):
        with tracer.start_span("fails"):
            raise RuntimeError("boom")
    assert ring.spans()[-1]["status"] == "error"


def fixed_spans() -> list[dict]:
    """Span dicts with fixed ids and clock, over two services and three
    threads, with attributes, events and a zero duration."""
    out = []
    for i, (svc, thread) in enumerate([("tpu-serve", "h1"),
                                       ("tpu-serve", "h2"),
                                       ("router", "main"),
                                       ("tpu-serve", "h1")]):
        out.append({
            "name": f"span{i}", "service": svc, "thread": thread,
            "trace_id": TRACE, "span_id": f"{i + 1:016x}",
            "parent_id": "" if i == 0 else f"{i:016x}", "sampled": True,
            "start": 1700000000.123456 + i * 0.5,
            "duration": 0.0 if i == 3 else 0.25 * (i + 1),
            "status": "error" if i == 2 else "ok",
            "attributes": {"path": "/generate", "tokens": i},
            "events": [{"name": "e", "ts": 1700000000.2}] if i == 1 else []})
    return out


def test_chrome_trace_of_the_same_spans_is_equal():
    spans = fixed_spans()
    want = jexport.chrome_trace(spans)
    got = texport.chrome_trace(spans)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                          sort_keys=True)
    back = texport.spans_from_chrome(got)
    assert back == jexport.spans_from_chrome(want)
    assert [s["name"] for s in back] == [s["name"] for s in spans]


def test_record_span_exports_a_finished_operation():
    for mod, exp in ((jt, jexport), (tt, texport)):
        ring = exp.RingBufferExporter(4)
        tracer = mod.Tracer(service="svc", exporters=(ring,))
        ctx = mod.SpanContext(TRACE, SPAN, sampled=True)
        tracer.record_span("serve.engine.decode", ctx, start=10.0,
                           duration=-1.0, attributes={"tokens": 3},
                           status="error")
        tracer.record_span("dropped", mod.SpanContext(TRACE, SPAN, False),
                           start=0.0, duration=1.0)
        (s,) = ring.spans()
        assert (s["parent_id"], s["duration"], s["status"], s["start"]) == \
            (SPAN, 0.0, "error", 10.0)


@pytest.fixture()
def rings():
    """Both default rings, cleared before and after, holding the same
    fixed spans."""
    for ring in (jtracer.DEFAULT_RING, ttracer.DEFAULT_RING):
        ring.clear()
        ring.dropped = 0      # what earlier tests of the process evicted
        for s in fixed_spans():
            ring.export(s)
        ring.export(dict(fixed_spans()[0], trace_id="ab" * 16))
    yield
    for ring in (jtracer.DEFAULT_RING, ttracer.DEFAULT_RING):
        ring.clear()


@pytest.mark.parametrize("query", [
    "", f"?trace_id={TRACE}", "?trace_id=" + "ab" * 16, "?limit=2",
    f"?trace_id={TRACE}&limit=1", "?limit=0", "?limit=99999",
    "?limit=x", "?trace_id=" + "cd" * 16,
])
def test_debug_traces_body_answers_alike(rings, query):
    want = jexport.debug_traces_body("/debug/traces" + query)
    got = texport.debug_traces_body("/debug/traces" + query)
    assert got == want


def test_ring_counts_evictions():
    ring = texport.RingBufferExporter(2)
    for s in fixed_spans():
        ring.export(s)
    assert len(ring) == 2 and ring.dropped == 2
    assert [s["name"] for s in ring.spans()] == ["span2", "span3"]


def test_propagation_carriers_alike():
    ctx_j = jt.SpanContext(TRACE, SPAN)
    ctx_t = tt.SpanContext(TRACE, SPAN)
    obj_j = jprop.stamp_template({"spec": {}}, ctx_j)
    obj_t = tprop.stamp_template({"spec": {}}, ctx_t)
    assert obj_t == obj_j
    assert tprop.extract(obj_t).span_id == SPAN
    env = tprop.stamp_env({}, ctx_t)
    assert env == jprop.stamp_env({}, ctx_j)
    assert tprop.extract_env(env).trace_id == TRACE
    assert tprop.extract_env({}) is None
    assert tprop.TRACEPARENT_ENV == jprop.TRACEPARENT_ENV
