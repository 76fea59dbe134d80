"""The HTTP front end of the PyTorch port (tpu_dra_torch/workloads/
serve.py) on the CPU: /prefix, /stream, /metrics, /debug/slo and
/debug/overload, admission sheds, deadlines and the drain
(tests/test_serve.py, tests/test_serve_overload.py), the command line's
SIGTERM drain, and the reference server and the port's answering the
same requests on the same weights.

The overload cases pin the engine slow with the port's
``serve.engine.slow_decode`` failpoint, so requests are still in flight
where a case needs them to be."""

from __future__ import annotations

import http.client
import json
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_greedy_agrees, cfg_pair, jax_params, to_torch

from tpu_dra.workloads import decode as jd
from tpu_dra_torch.resilience import failpoint
from tpu_dra_torch.workloads import decode as td
from tpu_dra_torch.workloads.serve import serve

ROOT = Path(__file__).resolve().parent.parent
JCFG, TCFG = cfg_pair(vocab=96, d_model=64, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=128, max_seq=64, pos_emb="rope",
                      tied_embeddings=True)
# the scaled tied embedding spreads logit gaps past bf16 noise
JPARAMS = jax_params(JCFG, seed=3, embed_scale=4.0)
PARAMS = to_torch(JPARAMS)
PAGED = dict(slots=2, chunk=2, kv_layout="paged", page_size=8)
WAIT = 120


def base(srv) -> str:
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}"


def post(url, path, body, headers=None, timeout=WAIT):
    """(status, JSON body, headers) of a POST; HTTP errors answered
    too."""
    req = urllib.request.Request(
        f"{url}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), exc.headers


def get(url, path):
    try:
        with urllib.request.urlopen(f"{url}{path}", timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def series(text: str, key: str) -> float:
    for line in text.splitlines():
        if line.startswith(key + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def stream(url, body, headers=None):
    """The NDJSON lines of a /stream answer."""
    host, port = url.rsplit("/", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=WAIT)
    conn.request("POST", "/stream", body=json.dumps(body).encode(),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    assert resp.status == 200
    lines = [json.loads(ln) for ln in resp.read().decode().splitlines()
             if ln.strip()]
    conn.close()
    return lines


def port_decode(prompt, steps):
    return td.greedy_decode(TCFG, PARAMS, torch.tensor([prompt]),
                            steps=steps, max_len=64)[0].tolist()


def trimmed(tokens, seq):
    for j in range(len(seq), len(tokens) + 1):
        if tokens[j - len(seq):j] == seq:
            return tokens[:j - len(seq)]
    return tokens


@pytest.fixture(scope="module")
def server():
    srv = serve(TCFG, PARAMS, port=0, device="cpu", **PAGED)
    yield srv
    srv.shutdown()


@pytest.fixture()
def overload():
    """A paged server with a small admission bound; each case starts
    with clean counters and an idle pool."""
    srv = serve(TCFG, PARAMS, port=0, device="cpu", admission_max_cost=66,
                drain_grace_s=10.0, **PAGED)
    url = base(srv)
    post(url, "/generate", {"tokens": [[1, 2, 3]], "steps": 2})
    yield srv, url
    failpoint.reset()
    srv.shutdown()


# -------------------------------------------------------------------------
# /prefix, /stream, /metrics, /debug/slo
# -------------------------------------------------------------------------


def test_prefix_endpoint_then_generate(server):
    """tests/test_serve.py :266: /prefix registers, /generate with the id
    decodes like the full prompt; an unknown id is a 400."""
    url = base(server)
    code, out, _ = post(url, "/prefix", {"tokens": list(range(5, 25))})
    assert code == 200 and re.fullmatch(r"[0-9a-f]{16}", out["prefix_id"])
    code, gen, _ = post(url, "/generate", {"tokens": [[3, 1, 4], [6]],
                                           "steps": 6,
                                           "prefix_id": out["prefix_id"]})
    assert code == 200
    assert gen["tokens"] == [port_decode(list(range(5, 25)) + r, 6)
                             for r in ([3, 1, 4], [6])]
    code, bad, _ = post(url, "/generate", {"tokens": [[1]], "steps": 2,
                                           "prefix_id": "0" * 16})
    assert code == 400 and "unknown prefix_id" in bad["error"]
    code, bad, _ = post(url, "/prefix", {"tokens": []})
    assert code == 400


def test_stream_delivers_tokens_incrementally(server):
    """:304: token lines arrive while the request is in flight, equal the
    final tokens and a /generate of the same request; more than one row
    is a 400; an HTTP/1.0 client gets the buffered answer."""
    url = base(server)
    failpoint.activate("serve.engine.slow_decode=sleep(20)")
    try:
        host, port = server.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=WAIT)
        conn.request("POST", "/stream", body=json.dumps(
            {"tokens": [[1, 2, 3]], "steps": 40}).encode())
        resp = conn.getresponse()
        assert resp.status == 200
        lines, active_at_first = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            lines.append(json.loads(line))
            if active_at_first is None:
                active_at_first = server.engine.stats()["active"] >= 1
        conn.close()
    finally:
        failpoint.reset()
    assert active_at_first, "the first token came after the request ended"
    toks = [ln["token"] for ln in lines if "token" in ln]
    assert len(toks) == 40 and lines[-1] == {"done": True, "tokens": toks}
    _, gen, _ = post(url, "/generate", {"tokens": [[1, 2, 3]], "steps": 40})
    assert gen["tokens"] == [toks]
    code, _, _ = post(url, "/stream", {"tokens": [[1], [2]], "steps": 2})
    assert code == 400
    body = json.dumps({"tokens": [[1, 2]], "steps": 4}).encode()
    s = socket.create_connection((host, port), timeout=WAIT)
    s.sendall(f"POST /stream HTTP/1.0\r\nHost: t\r\nContent-Length: "
              f"{len(body)}\r\n\r\n".encode() + body)
    data = b""
    while chunk := s.recv(65536):
        data += chunk
    s.close()
    assert b"Transfer-Encoding: chunked" not in data
    payload = json.loads(data.split(b"\r\n\r\n", 1)[1])
    assert payload["done"] and len(payload["tokens"]) == 4


def test_stream_and_generate_stop_trim(server):
    """:605, :624: "stop" retires the request and trims the sequence;
    on /stream the final tokens are the trimmed ones, whatever streamed
    before the match completed."""
    url = base(server)
    _, ref, _ = post(url, "/generate", {"tokens": [[1, 2, 3]], "steps": 10})
    ref = ref["tokens"][0]
    stop = ref[3:5]
    _, got, _ = post(url, "/generate", {"tokens": [[1, 2, 3]], "steps": 10,
                                        "stop": [stop]})
    assert got["tokens"] == [trimmed(ref, stop)]
    lines = stream(url, {"tokens": [[1, 2, 3]], "steps": 10, "stop": [stop]})
    assert lines[-1] == {"done": True, "tokens": trimmed(ref, stop)}


def test_stream_disconnect_cancels_request():
    """:657: a client that walks away mid-stream cancels its request:
    the slot and its pages free and the engine counts the cancel."""
    srv = serve(TCFG, PARAMS, port=0, device="cpu", **PAGED)
    failpoint.activate("serve.engine.slow_decode=sleep(50)")
    try:
        host, port = srv.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("POST", "/stream", body=json.dumps(
            {"tokens": [[1, 2, 3]], "steps": 55}).encode())
        resp = conn.getresponse()
        assert resp.status == 200
        resp.fp.readline()                 # tokens are flowing
        try:
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        resp.close()
        conn.close()
        deadline = time.time() + 60
        while time.time() < deadline:
            st = srv.engine.stats()
            if st["cancelled"] >= 1 and st["active"] == 0:
                break
            time.sleep(0.05)
        st = srv.engine.stats()
        assert st["cancelled"] >= 1 and st["active"] == 0, st
        assert st["kv_pages_free"] == st["kv_pages_total"]
    finally:
        failpoint.reset()
        srv.shutdown()


def test_metrics_tenants_and_engine_gauges(server):
    """:161, :192, :788, :850: request series by path, code and tenant,
    tokens, the histograms, the engine gauges; a 400 lands in its own
    series."""
    url = base(server)
    post(url, "/generate", {"tokens": [[1, 2, 3]], "steps": 2},
         headers={"X-Tenant": "acme"})
    post(url, "/generate", {"tokens": [[4, 5]], "steps": 2})
    _, text = get(url, "/metrics")
    assert "# TYPE tpu_serve_requests_total counter" in text
    for key in ('tpu_serve_requests_total{path="/generate",code="200",'
                'tenant="acme"}',
                'tpu_serve_requests_total{path="/generate",code="200",'
                'tenant="default"}', "tpu_serve_generated_tokens_total",
                'tpu_serve_ttft_seconds_count{tenant="acme"}',
                "tpu_serve_engine_slots", "tpu_serve_engine_kv_pages_total",
                "tpu_serve_engine_completed"):
        assert series(text, key) > 0, key
    assert "# TYPE tpu_serve_engine_batch_occupancy gauge" in text
    assert "tpu_serve_request_seconds_bucket" in text and "# {" not in text
    key400 = ('tpu_serve_requests_total{path="/generate",code="400",'
              'tenant="default"}')
    before = series(text, key400)
    post(url, "/generate", {"tokens": []})
    assert series(get(url, "/metrics")[1], key400) == before + 1
    # client-chosen paths collapse into one label
    get(url, "/no/such/path")


def test_debug_slo_and_overload(server):
    """:858: availability and latency objectives with multi-window burn
    rates; a 400 is not an availability failure.  /debug/overload
    carries the engine's saturation signals."""
    url = base(server)
    post(url, "/generate", {"tokens": [[1, 2]], "steps": 2})
    post(url, "/generate", {"tokens": [], "steps": 2})
    slo = json.loads(get(url, "/debug/slo")[1])
    assert set(slo["objectives"]) == {"availability", "latency"}
    avail = slo["objectives"]["availability"]
    assert avail["target"] == 0.999 and avail["lifetime"]["bad"] == 0
    assert all(avail["windows"][f"{w}s"]["burn_rate"] == 0.0
               for w in slo["windows_s"])
    over = json.loads(get(url, "/debug/overload")[1])
    assert over["state"] == "running" and over["admission"] is None
    assert over["engine"]["kv_pages_total"] == 16


@pytest.mark.parametrize("method,path,item", [
    ("POST", "/beam", "item 7"), ("POST", "/speculative", "item 7"),
    ("POST", "/prefill", "item 8"), ("POST", "/decode_handoff", "item 8"),
    ("GET", "/debug/traces", "item 7"), ("GET", "/debug/jax-trace",
                                         "item 7")])
def test_unported_endpoints_name_their_item(server, method, path, item):
    """Every endpoint of the reference is served now, each with the
    reference's answer to this request: item 7's
    (tests/test_torch_serve_pool.py holds them in full) and item 8's,
    the KV handoff (tests/test_torch_kv_handoff.py): /prefill exports
    the one row, and /decode_handoff without a blob is a 400."""
    url = base(server)
    if method == "POST":
        code, body, _ = post(url, path, {"tokens": [[1]], "steps": 2})
        text = body.get("error", "")
    elif path == "/debug/jax-trace":     # a tar.gz, not text
        try:
            with urllib.request.urlopen(f"{url}{path}?seconds=0.1",
                                        timeout=WAIT) as r:
                code = r.status
        except urllib.error.HTTPError as exc:
            code = exc.code
    else:
        code, text = get(url, path)
    if path == "/prefill":
        assert code == 200 and body["length"] == 1 and body["blob"]
    elif path == "/decode_handoff":
        assert code == 400 and "blob" in text
    elif path == "/beam":
        assert code == 200 and len(body["tokens"][0]) == 4
    elif path == "/speculative":
        assert code == 400 and "no draft model armed" in text
    elif path == "/debug/traces":
        assert code == 200 and "traceEvents" in text
    else:
        assert code in (200, 503)      # 503: the profiler refused


def test_keepalive_survives_early_answers(server):
    """:400: an early 404 drains its body, and a 400 for a body that does
    not parse has read it, so the next request on the same connection
    parses."""
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=WAIT)
    for path, body, status in (("/nope", b"x" * 512, 404),
                               ("/prefill", b"y" * 64, 400),
                               ("/generate", json.dumps(
                                   {"tokens": [[3]], "steps": 2}).encode(),
                                200)):
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        assert resp.status == status
        resp.read()
    conn.close()


# -------------------------------------------------------------------------
# Overload: tests/test_serve_overload.py
# -------------------------------------------------------------------------


def test_oversized_request_sheds_fast_503(overload):
    srv, url = overload
    t0 = time.perf_counter()
    code, body, headers = post(url, "/generate",
                               {"tokens": [[1] * 40, [2] * 40], "steps": 20})
    assert time.perf_counter() - t0 < 2.0
    assert code == 503 and body["reason"] == "cost_too_large"
    assert headers["Retry-After"].isdigit()
    assert int(headers["Retry-After"]) >= 1
    assert series(get(url, "/metrics")[1],
                  'tpu_serve_shed_total{reason="cost_too_large"}') == 1
    over = json.loads(get(url, "/debug/overload")[1])
    assert over["admission"]["shed_total"]["cost_too_large"] == 1


def test_queue_full_sheds_while_engine_is_pinned(overload):
    srv, url = overload
    failpoint.activate("serve.engine.slow_decode=sleep(150)")
    slow = threading.Thread(target=post, args=(
        url, "/generate", {"tokens": [[1, 2, 3]], "steps": 32}), daemon=True)
    slow.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and json.loads(get(
            url, "/debug/overload")[1])["admission"]["outstanding_cost"] < 35:
        time.sleep(0.01)
    shed = None
    while time.monotonic() < deadline and shed is None:
        code, body, headers = post(url, "/generate", {
            "tokens": [[4] * 8, [5] * 8], "steps": 10}, timeout=10)
        if code == 503:
            shed = body
            assert body["reason"] in ("queue_full", "tenant_quota")
            assert int(headers["Retry-After"]) >= 1
        time.sleep(0.02)
    failpoint.reset()
    slow.join(timeout=60)
    assert shed is not None, "no shed while the engine was pinned"


def test_deadline_expiry_releases_pages_and_counts_badput(overload):
    """The 504 `deadline_expired`, the pages back in the pool, the slot
    time counted as badput and not goodput."""
    srv, url = overload
    base_eng = json.loads(get(url, "/debug/overload")[1])["engine"]
    assert base_eng["kv_pages_free"] == base_eng["kv_pages_total"]
    failpoint.activate("serve.engine.slow_decode=sleep(100)")
    try:
        code, body, _ = post(url, "/generate",
                             {"tokens": [[1, 2, 3]], "steps": 40},
                             headers={"X-Deadline-Ms": "250"})
    finally:
        failpoint.reset()
    assert code == 504 and body["reason"] == "deadline_expired"
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        eng = json.loads(get(url, "/debug/overload")[1])["engine"]
        if eng["kv_pages_free"] == eng["kv_pages_total"]:
            break
        time.sleep(0.05)
    assert eng["kv_pages_free"] == eng["kv_pages_total"], eng
    assert eng["expired_active"] == 1
    assert eng["badput_slot_s"]["deadline_expired"] > 0
    assert eng["goodput_slot_s"] == pytest.approx(base_eng["goodput_slot_s"],
                                                  abs=1.0)
    assert series(get(url, "/metrics")[1],
                  'tpu_serve_shed_total{reason="deadline_expired"}') == 1


def test_queued_request_expires_without_badput(overload):
    srv, url = overload
    failpoint.activate("serve.engine.slow_decode=sleep(120)")
    try:
        occupiers = [threading.Thread(target=post, args=(
            url, "/generate", {"tokens": [[s, 2, 3]], "steps": 24},
            {"X-Tenant": f"occ{s}"}), daemon=True) for s in (1, 2)]
        for t in occupiers:
            t.start()
        time.sleep(0.4)
        code, _, _ = post(url, "/generate", {"tokens": [[9, 8, 7]],
                                             "steps": 2},
                          headers={"X-Deadline-Ms": "200"}, timeout=30)
        assert code == 504
        for t in occupiers:
            t.join(timeout=60)
    finally:
        failpoint.reset()
    eng = json.loads(get(url, "/debug/overload")[1])["engine"]
    assert eng["expired_queued"] >= 1
    assert eng["badput_slot_s"]["deadline_expired"] == 0.0


def test_invalid_deadline_header_is_ignored(overload):
    srv, url = overload
    for bad in ("abc", "-5", "inf", "nan", ""):
        code, out, _ = post(url, "/generate", {"tokens": [[1, 2, 3]],
                                               "steps": 2},
                            headers={"X-Deadline-Ms": bad})
        assert code == 200 and len(out["tokens"][0]) == 2


def test_drain_closes_admission_and_finishes_in_flight(overload):
    srv, url = overload
    failpoint.activate("serve.engine.slow_decode=sleep(100)")
    result = {}
    t = threading.Thread(target=lambda: result.update(resp=post(
        url, "/generate", {"tokens": [[1, 2, 3]], "steps": 24})),
        daemon=True)
    t.start()
    time.sleep(0.4)
    drained = {}
    dt = threading.Thread(target=lambda: drained.update(ok=srv.drain(20.0)),
                          daemon=True)
    dt.start()
    time.sleep(0.2)
    code, text = get(url, "/healthz")
    assert code == 503 and "draining" in text
    code, body, headers = post(url, "/generate", {"tokens": [[4, 5]],
                                                  "steps": 2})
    assert code == 503 and body["reason"] == "draining"
    assert int(headers["Retry-After"]) >= 1
    code, body, _ = post(url, "/stream", {"tokens": [[4, 5]], "steps": 2})
    assert code == 503 and body["reason"] == "draining"
    failpoint.reset()
    dt.join(timeout=30)
    t.join(timeout=30)
    assert drained.get("ok") is True
    code, out, _ = result["resp"]
    assert code == 200 and len(out["tokens"][0]) == 24
    assert json.loads(get(url, "/debug/overload")[1])["state"] == "draining"


def test_open_admission_and_engine_only_drain():
    """Without an admission bound nothing sheds and /debug/overload has
    no admission block; a drain entered through the engine alone still
    flips /healthz."""
    srv = serve(TCFG, PARAMS, port=0, device="cpu", **PAGED)
    url = base(srv)
    try:
        code, _, _ = post(url, "/generate", {"tokens": [[1] * 30],
                                             "steps": 20})
        assert code == 200
        over = json.loads(get(url, "/debug/overload")[1])
        assert over["state"] == "running" and over["admission"] is None
        assert get(url, "/healthz")[0] == 200
        assert srv.engine.drain(timeout=10.0) is True
        code, text = get(url, "/healthz")
        assert code == 503 and "draining" in text
        code, body, _ = post(url, "/generate", {"tokens": [[1]],
                                                "steps": 2})
        assert code == 503 and body["reason"] == "draining"
    finally:
        srv.shutdown()


def test_stream_deadline_counts_in_both_shed_surfaces(overload):
    srv, url = overload
    failpoint.activate("serve.engine.slow_decode=sleep(100)")
    try:
        lines = stream(url, {"tokens": [[1, 2, 3]], "steps": 40},
                       headers={"X-Deadline-Ms": "250"})
        assert lines and lines[-1].get("reason") == "deadline_expired"
    finally:
        failpoint.reset()
    assert series(get(url, "/metrics")[1],
                  'tpu_serve_shed_total{reason="deadline_expired"}') == 1
    over = json.loads(get(url, "/debug/overload")[1])
    assert over["admission"]["shed_total"]["deadline_expired"] == 1
    assert over["admission"]["outstanding_cost"] == 0


def test_failpoint_is_one_flag_when_disarmed():
    failpoint.reset()
    assert failpoint._armed is False
    failpoint.hit("serve.engine.slow_decode")          # no-op
    failpoint.activate("serve.engine.slow_decode=1*error(ValueError)")
    with pytest.raises(ValueError, match="failpoint"):
        failpoint.hit("serve.engine.slow_decode")
    failpoint.hit("serve.engine.slow_decode")          # spent
    failpoint.reset()
    with pytest.raises(ValueError, match="malformed"):
        failpoint.activate("no-equals-sign")
    names = {f.name for f in failpoint.registered()}
    assert {"serve.engine.slow_decode", "serve.admission.stall"} <= names


# -------------------------------------------------------------------------
# The command line's SIGTERM drain, and the two servers side by side
# -------------------------------------------------------------------------


def test_main_sigterm_drains_and_exits():
    """:738: SIGTERM with a request in flight: the request gets its
    answer, the server drains and exits 0."""
    cmd = [sys.executable, "-m", "tpu_dra_torch.workloads.serve",
           "--continuous", "--init-seed", "0", "--device", "cpu",
           "--port", "0", "--host", "127.0.0.1", "--vocab", "64",
           "--d-model", "32", "--n-heads", "2", "--n-layers", "2",
           "--d-ff", "64", "--max-seq", "64", "--slots", "2", "--chunk",
           "2", "--kv-layout", "paged", "--page-size", "8",
           "--admission-max-cost", "200", "--drain-grace", "20"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        # the ready line under a deadline: readline blocks, so it runs on
        # a thread the deadline can give up on
        lines: list[str] = []

        def read_ready():
            while True:
                line = proc.stdout.readline()
                lines.append(line)
                if not line or "serving on" in line:
                    return
        reader = threading.Thread(target=read_ready, daemon=True)
        reader.start()
        reader.join(timeout=WAIT)
        line = lines[-1] if lines else ""
        assert "serving on" in line, \
            f"the server did not serve within {WAIT}s: {''.join(lines)}"
        url = f"http://127.0.0.1:{re.search(r', (\d+)\)', line).group(1)}"
        post(url, "/generate", {"tokens": [[1, 2]], "steps": 2})
        result = {}
        t = threading.Thread(target=lambda: result.update(resp=post(
            url, "/generate", {"tokens": [[1, 2, 3]], "steps": 50})),
            daemon=True)
        t.start()
        # SIGTERM only once the 50-step request is in flight (or already
        # answered): before its admission a drain would shed it
        deadline = time.monotonic() + WAIT
        while t.is_alive() and \
                json.loads(get(url, "/stats")[1])["active"] < 1:
            assert time.monotonic() < deadline, "the request never ran"
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=60)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == 0, out[-400:]
    assert "drain before shutdown: complete=True" in out, out[-400:]
    code, body, _ = result["resp"]
    assert code == 200 and len(body["tokens"][0]) == 50


def ref_logits(prompt, tokens):
    cache = jd.init_kv_cache(JCFG, 1, 64)
    cache, lg = jd.prefill(JCFG, JPARAMS, cache,
                           jnp.asarray([prompt], jnp.int32))
    out = [np.asarray(lg)[0]]
    for i, tok in enumerate(tokens[:-1]):
        lg, cache = jd._token_logits(JCFG, JPARAMS, cache, len(prompt) + i,
                                     jnp.asarray([tok], jnp.int32))
        out.append(np.asarray(lg)[0])
    return np.stack(out)


def test_reference_and_port_servers_answer_alike():
    """The reference server and the port's, on the same converted
    weights: /prefix gives the same id; /generate with the id and with a
    stop gives the same greedy answers (a row may part only at a
    reference near-tie, ``assert_greedy_agrees``), trimmed alike; the
    two /metrics name the same series and /debug/overload and /debug/slo
    carry the same keys."""
    from tpu_dra.workloads.serve import serve as jserve
    jsrv = jserve(JCFG, JPARAMS, port=0, continuous=True, **PAGED)
    tsrv = serve(TCFG, PARAMS, port=0, device="cpu", **PAGED)
    prefix = list(range(5, 25))
    rows = [[3, 1, 4], [1, 5, 9, 2], [6]]
    try:
        answers = []
        for srv in (jsrv, tsrv):
            url = base(srv)
            code, pid, _ = post(url, "/prefix", {"tokens": prefix})
            assert code == 200
            _, full, _ = post(url, "/generate", {
                "tokens": rows, "steps": 12, "prefix_id": pid["prefix_id"]})
            stop = [full["tokens"][1][2:4]] if not answers else \
                answers[0]["stop"]
            _, stopped, _ = post(url, "/generate", {
                "tokens": rows, "steps": 12, "prefix_id": pid["prefix_id"],
                "stop": stop})
            answers.append({
                "pid": pid["prefix_id"], "full": full["tokens"],
                "stop": stop, "stopped": stopped["tokens"],
                "metrics": {ln.split("{")[0].split(" ")[0] for ln in
                            get(url, "/metrics")[1].splitlines()
                            if ln.startswith("tpu_serve_")
                            and "engine" not in ln},
                "overload": json.loads(get(url, "/debug/overload")[1]),
                "slo": json.loads(get(url, "/debug/slo")[1])})
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
    want, got = answers
    assert got["pid"] == want["pid"]
    for r, w, g, ws, gs in zip(rows, want["full"], got["full"],
                               want["stopped"], got["stopped"]):
        agreed = assert_greedy_agrees(w, ref_logits(prefix + r, w), g)
        assert ws == trimmed(w, want["stop"][0])
        assert gs == trimmed(g, want["stop"][0])
        if agreed == len(w):
            assert gs == ws
    assert got["full"][1] == want["full"][1]      # the stop's own row
    assert got["stopped"][1] == want["stopped"][1]
    assert got["metrics"] == want["metrics"]
    assert set(got["overload"]) == set(want["overload"])
    assert set(got["overload"]["engine"]) <= set(want["overload"]["engine"])
    assert set(got["slo"]) == set(want["slo"])
    assert set(got["slo"]["objectives"]["latency"]) == \
        set(want["slo"]["objectives"]["latency"])
