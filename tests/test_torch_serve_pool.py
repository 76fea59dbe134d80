"""The bucketed DecoderPool of the PyTorch port's server
(tpu_dra_torch/workloads/serve.py) on the CPU: the pool cases of
tests/test_serve.py on a ``continuous=False`` server, held to the
reference's DecoderPool on the same converted weights, and to the port's
own decoders at the same shapes; /beam and /speculative beside a
continuous engine; the spans, exemplars and the device trace of both
server modes; the command line without ``--continuous``.

Greedy answers equal the reference's, or part from them only where the
reference's top-2 margin is a bf16 near-tie (``assert_greedy_agrees``);
beam scores within ``SCORE_TOL`` of the reference's."""

from __future__ import annotations

import concurrent.futures
import io
import json
import subprocess
import sys
import tarfile
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_greedy_agrees, cfg_pair, jax_params, to_torch

from tpu_dra.workloads import decode as jd
from tpu_dra.workloads.serve import DecoderPool as JaxPool
from tpu_dra.workloads.train import init_params as jax_init
from tpu_dra_torch.convert import save_npz
from tpu_dra_torch.workloads import decode as td
from tpu_dra_torch.workloads.serve import DecoderPool, serve

ROOT = Path(__file__).resolve().parent.parent
# tests/test_serve.py's server model
JCFG, TCFG = cfg_pair(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                      max_seq=32)
JPARAMS = jax_params(JCFG)
PARAMS = to_torch(JPARAMS)
# its draft (tests/test_serve.py :236)
JDCFG, TDCFG = cfg_pair(vocab=64, d_model=16, n_heads=2, n_layers=1,
                        d_ff=32, max_seq=32)
JDPARAMS = jax_init(JDCFG, jax.random.PRNGKey(7))
DPARAMS = to_torch(JDPARAMS)
# a beam score is a sum of bf16-path log-probabilities: the largest gap
# between the packages measured on these fixtures is 0.021 over 4 steps
# (0.041 over 6, tests/test_torch_beam.py)
SCORE_TOL = 0.05
WAIT = 120
TRACEPARENT = "00-" + "7e" * 16 + "-" + "1b" * 8 + "-01"


def base(srv) -> str:
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}"


def post(url, path, body, headers=None):
    req = urllib.request.Request(
        f"{url}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def get(url, path, headers=None):
    req = urllib.request.Request(f"{url}{path}", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), exc.headers


def ref_logits(row, tokens):
    """The reference's greedy logits that chose each of ``tokens``."""
    cache = jd.init_kv_cache(JCFG, 1, JCFG.max_seq)
    cache, lg = jd.prefill(JCFG, JPARAMS, cache, jnp.asarray([row],
                                                             jnp.int32))
    out = [np.asarray(lg)[0]]
    for i, tok in enumerate(tokens[:-1]):
        lg, cache = jd._token_logits(JCFG, JPARAMS, cache, len(row) + i,
                                     jnp.asarray([tok], jnp.int32))
        out.append(np.asarray(lg)[0])
    return np.stack(out)


def agrees(rows, want, got):
    for row, w, g in zip(rows, want, got):
        assert_greedy_agrees(w, ref_logits(row, w), g)


@pytest.fixture(scope="module")
def server():
    srv = serve(TCFG, PARAMS, port=0, continuous=False, device="cpu")
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def jax_pool():
    pool = JaxPool(JCFG, JPARAMS)
    pool.set_draft(JDCFG, JDPARAMS)
    return pool


GREEDY = [([[3, 1, 4, 1, 5]], 6), ([[1, 2, 3], [9, 8, 7, 6, 5, 4, 3]], 4),
          ([[i + 1, (2 * i) % 64, 7] for i in range(8)], 3),
          ([[1, 2], [3]], 3)]


@pytest.mark.parametrize("rows,steps", GREEDY,
                         ids=["one", "mixed", "eight", "short"])
def test_generate_follows_the_reference_pool(server, jax_pool, rows, steps):
    """tests/test_serve.py :64, :73, :83, :161: /generate on the pool
    against the reference's DecoderPool of the same converted weights."""
    code, out = post(base(server), "/generate",
                     {"tokens": rows, "steps": steps})
    assert code == 200
    agrees(rows, jax_pool.generate(rows, steps), out["tokens"])


@pytest.mark.parametrize("knobs", [
    {"eos_id": 5}, {"repetition_penalty": 1.5},
    {"eos_id": 7, "repetition_penalty": 1.3}], ids=["eos", "rep", "both"])
def test_generate_eos_and_repetition_penalty_equal_the_reference(
        server, jax_pool, knobs):
    rows = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3], [5, 5]]
    code, out = post(base(server), "/generate",
                     {"tokens": rows, "steps": 8, **knobs})
    assert code == 200
    assert out["tokens"] == jax_pool.generate(rows, 8, **knobs)
    if "eos_id" in knobs:
        for r in out["tokens"]:
            if knobs["eos_id"] in r:
                first = r.index(knobs["eos_id"])
                assert all(t == knobs["eos_id"] for t in r[first:])


def test_ragged_rows_decode_as_one_padded_bucket(server):
    """Three rows of lengths 3, 7 and 2 run as one batch of 4 (a dummy
    row) at the prompt bucket 8: bit-equal to ``decode`` of that padded
    batch with the rows' lengths."""
    rows = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3], [5, 5]]
    code, out = post(base(server), "/generate", {"tokens": rows,
                                                 "steps": 5})
    assert code == 200
    prompts = torch.zeros((4, 8), dtype=torch.int32)
    for i, r in enumerate(rows):
        prompts[i, :len(r)] = torch.tensor(r)
    want = td.decode(TCFG, PARAMS, prompts, steps=5, lengths=[3, 7, 2, 1])
    assert out["tokens"] == want[:3].tolist()


def test_concurrent_requests_all_correct(server):
    """:83: concurrent requests through the threaded server: every answer
    equals the pool's answer alone."""
    pool = server.pool
    prompts = [[i + 1, (2 * i) % 64, 7] for i in range(8)]
    want = {tuple(p): pool.generate([p], 3)[0] for p in prompts}

    def hit(p):
        return p, post(base(server), "/generate",
                       {"tokens": [p], "steps": 3})[1]["tokens"][0]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        for p, got in ex.map(hit, prompts * 2):
            assert got == want[tuple(p)]


def test_sampled_generate_is_seeded(server):
    body = {"tokens": [[1, 2, 3], [4, 5]], "steps": 6, "temperature": 0.9,
            "top_k": 8, "top_p": 0.9, "seed": 11}
    a, b = (post(base(server), "/generate", body)[1]["tokens"]
            for _ in range(2))
    assert a == b and all(len(r) == 6 and all(0 <= t < 64 for t in r)
                          for r in a)


@pytest.mark.parametrize("path,body", [
    ("/generate", {"tokens": [], "steps": 2}),
    ("/generate", {"tokens": [[999]], "steps": 2}),
    ("/generate", {"tokens": [[1]], "steps": 999}),
    ("/generate", {"tokens": [[1]], "steps": 2, "top_p": 1.5}),
    ("/generate", {"tokens": [[1]], "steps": 2, "eos_id": 64}),
    ("/generate", {"tokens": [[1]], "steps": 2, "repetition_penalty": 0}),
    ("/beam", {"tokens": [[1, 2], [3]], "steps": 2}),
    ("/beam", {"tokens": [[1, 2]], "steps": 2, "beams": 65}),
    ("/beam", {"tokens": [[1, 2]], "steps": 2, "length_penalty": 0.5}),
    ("/beam", {"tokens": [[1, 2]], "steps": 40}),
    ("/speculative", {"tokens": [[1, 2]], "steps": 4}),
    ("/prefix", {"tokens": [1, 2]}),
], ids=["empty", "token", "steps", "top_p", "eos", "penalty",
        "beam-ragged", "beams", "penalty-no-eos", "beam-steps",
        "no-draft", "prefix"])
def test_bad_requests_are_400(server, path, body):
    """:103, :133, :220, :266: the reference's 400s, each with its
    reason."""
    code, out = post(base(server), path, body)
    assert code == 400 and out["error"]
    if path == "/speculative":
        assert "draft" in out["error"]
    if path == "/prefix":
        assert "--continuous" in out["error"]


def test_stream_needs_continuous(server):
    """:389."""
    code, out = post(base(server), "/stream", {"tokens": [[1]],
                                               "steps": 2})
    assert code == 400 and "streaming needs --continuous" in out["error"]


def test_beam_endpoint_follows_the_reference(server, jax_pool):
    """:133: W best-first hypotheses per row, the reference's
    hypotheses, scores within SCORE_TOL; bit-equal to ``beam_decode``
    of the port at the same shapes (the batch bucket of 2)."""
    rows = [[1, 2, 3], [4, 5, 6]]
    code, out = post(base(server), "/beam", {"tokens": rows, "steps": 4,
                                             "beams": 3})
    assert code == 200
    hyps, scores = jax_pool.beam(rows, 4, 3)
    assert out["tokens"] == hyps
    np.testing.assert_allclose(out["scores"], scores, atol=SCORE_TOL)
    assert all(s[0] >= s[-1] for s in out["scores"])
    hist, sc = td.beam_decode(TCFG, PARAMS, torch.tensor(rows), steps=4,
                              beams=3)
    assert out["tokens"] == hist.tolist() and out["scores"] == sc.tolist()


def test_speculative_endpoint_follows_the_reference(jax_pool):
    """:220: with a draft armed the tokens are the greedy tokens and
    ``target_passes`` equals the reference's on this greedy fixture;
    bit-equal to the port's ``speculative_decode`` at the same shapes."""
    srv = serve(TCFG, PARAMS, port=0, continuous=False,
                draft=(TDCFG, DPARAMS), device="cpu")
    try:
        for rows, steps, k in (([[1, 2, 3], [4, 5, 6]], 6, 3),
                               ([[7, 8, 9, 10]], 10, 4)):
            code, out = post(base(srv), "/speculative",
                             {"tokens": rows, "steps": steps, "k": k})
            assert code == 200
            toks, passes = jax_pool.speculative(rows, steps, k)
            assert out["tokens"] == toks
            assert out["target_passes"] == passes
            assert 1 <= passes <= steps
            want, stats = td.speculative_decode(
                TCFG, PARAMS, TDCFG, DPARAMS, torch.tensor(rows),
                steps=steps, k=k, return_stats=True)
            assert out["tokens"] == want.tolist()
            assert out["target_passes"] == stats["target_passes"]
            greedy = td.greedy_decode(TCFG, PARAMS, torch.tensor(rows),
                                      steps=steps)
            assert out["tokens"] == greedy.tolist()
        code, out = post(base(srv), "/speculative",
                         {"tokens": [[1, 2]], "steps": 4, "k": 1})
        assert code == 400 and "k must be in [2, 16]" in out["error"]
    finally:
        srv.shutdown()


def test_speculative_rejects_mismatched_draft_vocab():
    """:255."""
    pool = DecoderPool(TCFG, PARAMS, device="cpu")
    bad = cfg_pair(vocab=65, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                   max_seq=32)[1]
    with pytest.raises(ValueError, match="vocab"):
        pool.set_draft(bad, None)


def test_beam_and_speculative_beside_a_continuous_engine():
    """The pool is built in every mode: beside a paged continuous engine
    /beam and /speculative answer from the pool, /generate from the
    engine, and the engine does not speculate without
    speculative_engine."""
    srv = serve(TCFG, PARAMS, port=0, continuous=True, kv_layout="paged",
                page_size=8, slots=2, chunk=2, draft=(TDCFG, DPARAMS),
                device="cpu")
    try:
        url = base(srv)
        rows = [[1, 2, 3], [4, 5, 6]]
        code, out = post(url, "/beam", {"tokens": rows, "steps": 4,
                                        "beams": 2})
        assert code == 200 and len(out["tokens"][0]) == 2
        code, out = post(url, "/speculative", {"tokens": rows, "steps": 6,
                                               "k": 3})
        greedy = td.greedy_decode(TCFG, PARAMS, torch.tensor(rows), steps=6)
        assert code == 200 and out["tokens"] == greedy.tolist()
        code, out = post(url, "/generate", {"tokens": rows, "steps": 3})
        assert code == 200 and srv.engine.stats()["completed"] == 2
        assert srv.engine.draft is None
    finally:
        srv.shutdown()


def test_serve_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="requires --continuous"):
        serve(TCFG, PARAMS, port=0, continuous=False, kv_layout="paged",
              device="cpu")
    with pytest.raises(ValueError, match="speculative_engine needs"):
        serve(TCFG, PARAMS, port=0, continuous=False,
              draft=(TDCFG, DPARAMS), speculative_engine=True,
              device="cpu")
    with pytest.raises(ValueError, match="logit_bias needs"):
        serve(TCFG, PARAMS, port=0, continuous=False, logit_bias={1: -1e9},
              device="cpu")


def spans_of(url, trace_id):
    code, body, _ = get(url, f"/debug/traces?trace_id={trace_id}")
    assert code == 200, body
    return [e for e in json.loads(body)["traceEvents"] if e["ph"] == "X"]


def test_request_joins_incoming_traceparent(server):
    """:41: the request's serve.request span runs inside the caller's
    trace, and the id resolves on /debug/traces."""
    code, _ = post(base(server), "/beam", {"tokens": [[1, 2]], "steps": 2},
                   headers={"traceparent": TRACEPARENT})
    assert code == 200
    spans = spans_of(base(server), TRACEPARENT.split("-")[1])
    req = [s for s in spans if s["name"] == "serve.request"]
    assert req and req[0]["args"]["parent_id"] == "1b" * 8
    assert req[0]["args"]["path"] == "/beam"
    # an id no request of this process carried
    code, body, _ = get(base(server), "/debug/traces?trace_id=" + "9d" * 16)
    assert code == 404 and b"not found" in body


def test_unsampled_request_records_nothing(server):
    tp = "00-" + "5a" * 16 + "-" + "1b" * 8 + "-00"
    post(base(server), "/generate", {"tokens": [[1]], "steps": 2},
         headers={"traceparent": tp})
    code, _, _ = get(base(server), "/debug/traces?trace_id=" + "5a" * 16)
    assert code == 404


def test_engine_decode_span_and_exemplars_resolve():
    """:788 on a continuous engine: a request with a traceparent leaves
    its serve.request span and the engine's serve.engine.decode child;
    an OpenMetrics scrape carries an exemplar trace id that resolves on
    /debug/traces; the plain scrape stays exemplar-free."""
    srv = serve(TCFG, PARAMS, port=0, continuous=True, kv_layout="paged",
                page_size=8, slots=2, chunk=2, device="cpu")
    try:
        url = base(srv)
        tp = "00-" + "3c" * 16 + "-" + "2d" * 8 + "-01"
        code, _ = post(url, "/generate", {"tokens": [[1, 2, 3]], "steps": 4},
                       headers={"traceparent": tp, "X-Tenant": "acme"})
        assert code == 200
        spans = {s["name"]: s for s in spans_of(url, "3c" * 16)}
        assert {"serve.request", "serve.engine.decode"} <= set(spans)
        assert spans["serve.engine.decode"]["args"]["parent_id"] == \
            spans["serve.request"]["args"]["span_id"]
        assert spans["serve.engine.decode"]["args"]["tokens"] == 4
        code, body, headers = get(
            url, "/metrics",
            headers={"Accept": "application/openmetrics-text"})
        text = body.decode()
        assert headers["Content-Type"].startswith(
            "application/openmetrics-text") and text.endswith("# EOF\n")
        ids = {ln.split('trace_id="')[1].split('"')[0]
               for ln in text.splitlines()
               if ln.startswith("tpu_serve_request_seconds_bucket")
               and 'tenant="acme"' in ln and "# {" in ln}
        assert ids == {"3c" * 16}
        assert any(ln.startswith("tpu_serve_ttft_seconds_bucket")
                   and "3c" * 16 in ln for ln in text.splitlines())
        for tid in ids:
            assert spans_of(url, tid)
        code, body, headers = get(url, "/metrics")
        assert headers["Content-Type"].startswith("text/plain") and \
            b"# {" not in body
    finally:
        srv.shutdown()


def test_device_trace_capture(server):
    """:114: /debug/jax-trace returns a tar.gz whose members sit under
    jax-trace/ (the reference's layout) while the server keeps answering;
    seconds outside [0, 30] are a 400; a second capture at once a 503."""
    url = base(server)
    out: dict = {}

    def capture():
        out["trace"] = get(url, "/debug/jax-trace?seconds=1")
    t = threading.Thread(target=capture)
    t.start()
    code, _ = post(url, "/generate", {"tokens": [[1, 2]], "steps": 3})
    assert code == 200                     # answered during the capture
    code, body, _ = get(url, "/debug/jax-trace?seconds=0.1")
    t.join(WAIT)
    assert not t.is_alive()
    assert code == 503 and b"already running" in body
    code, body, headers = out["trace"]
    assert code == 200 and headers["Content-Type"] == "application/gzip"
    with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
        names = tar.getnames()
        trace = json.load(tar.extractfile("jax-trace/trace.json"))
    assert "jax-trace/trace.json" in names
    assert len(trace["traceEvents"]) == int(headers["X-Trace-Events"]) > 0
    assert headers["X-Trace-Kernel-Events"] == "0"     # no card here
    for bad in ("31", "-1", "x", "nan"):
        code, body, _ = get(url, f"/debug/jax-trace?seconds={bad}")
        assert code == 400 and b"seconds" in body


def test_cli_serves_the_pool_without_continuous(tmp_path):
    """``python -m tpu_dra_torch.workloads.serve --init-seed 0`` without
    --continuous serves /generate, /beam and /speculative (a draft from
    --draft-params-npz), answers /debug/traces, and refuses the engine's
    endpoints; SIGTERM drains and exits 0."""
    cfg = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               max_seq=32)
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in cfg.items()]
    npz = tmp_path / "draft.npz"
    save_npz(npz, DPARAMS)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_dra_torch.workloads.serve",
         "--init-seed", "0", "--device", "cpu", "--port", "0", "--host",
         "127.0.0.1", "--pos-emb", "learned", *flags,
         "--draft-params-npz", str(npz), "--draft-d-model", "16",
         "--draft-n-heads", "2", "--draft-n-layers", "1", "--draft-d-ff",
         "32"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        for line in proc.stdout:
            if line.startswith("serving on"):
                break
        port = int(line.rsplit(",", 1)[1].strip(" )\n"))
        url = f"http://127.0.0.1:{port}"
        rows = [[1, 2, 3], [4, 5, 6]]
        code, gen = post(url, "/generate", {"tokens": rows, "steps": 5})
        assert code == 200 and [len(r) for r in gen["tokens"]] == [5, 5]
        code, beam = post(url, "/beam", {"tokens": rows, "steps": 5,
                                         "beams": 2})
        assert code == 200 and len(beam["scores"][0]) == 2
        code, spec = post(url, "/speculative", {"tokens": rows, "steps": 5})
        assert code == 200 and spec["tokens"] == gen["tokens"]
        assert get(url, "/debug/traces")[0] == 200
        assert post(url, "/stream", {"tokens": [[1]]})[0] == 400
        code, out = post(url, "/prefill", {"tokens": [[1]]})
        assert code == 400 and "--continuous" in out["error"]
        code, out = post(url, "/decode_handoff", {"blob": "", "steps": 2})
        assert code == 400 and "--continuous" in out["error"]
        proc.terminate()
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == 0
    assert "drain before shutdown: complete=True" in rest
