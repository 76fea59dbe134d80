"""HTTP front end of the PyTorch port (tpu_dra_torch/workloads/serve.py)
on the CPU: /healthz, /stats and /generate over the continuous paged
engine."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

from torch_parity import cfg_pair, jax_params, to_torch

from tpu_dra_torch.workloads.serve import main, serve

JCFG, TCFG = cfg_pair(vocab=96, d_model=64, n_heads=4, n_kv_heads=2,
                   n_layers=2, d_ff=128, max_seq=64, pos_emb="rope")
PARAMS = to_torch(jax_params(JCFG, seed=3))


@pytest.fixture(scope="module")
def server():
    srv = serve(TCFG, PARAMS, port=0, slots=4, chunk=2, page_size=8,
                device="cpu")
    yield srv
    srv.shutdown()


def url(srv, path):
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}{path}"


def post(srv, path, body):
    req = urllib.request.Request(
        url(srv, path), data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_healthz_and_stats(server):
    with urllib.request.urlopen(url(server, "/healthz"), timeout=30) as r:
        assert r.status == 200 and r.read() == b"ok"
    with urllib.request.urlopen(url(server, "/stats"), timeout=30) as r:
        st = json.loads(r.read())
    assert st["slots"] == 4 and st["device"] == "cpu"
    assert st["kv_pages_total"] == 4 * 64 // 8


def test_generate_shape_and_equals_engine(server):
    rows = [[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9], [42]]
    code, out = post(server, "/generate", {"tokens": rows, "steps": 5})
    assert code == 200
    assert len(out["tokens"]) == len(rows)
    assert all(len(t) == 5 and all(isinstance(x, int) for x in t)
               for t in out["tokens"])
    # the same requests straight through the engine: same tokens
    want = [server.engine.submit(r, 5, timeout=120) for r in rows]
    assert out["tokens"] == want
    # sampled requests with a seed are reproducible over HTTP too
    body = {"tokens": [[9, 9]], "steps": 4, "temperature": 0.7, "seed": 3}
    assert post(server, "/generate", body) == post(server, "/generate", body)


@pytest.mark.parametrize("body", [
    {"tokens": [], "steps": 3},
    {"tokens": [[1, 2]], "steps": 0},
    {"tokens": [[1, 2]], "steps": 3, "top_k": 5},
    {"tokens": [[1, 2]], "steps": 3, "prefix_id": "p"},
    {"tokens": [[1, 2]], "steps": 3, "stop": [[4]]},
    {"steps": 3},
], ids=["empty", "steps0", "top_k", "prefix", "stop", "no-tokens"])
def test_bad_requests_are_400(server, body):
    code, out = post(server, "/generate", body)
    assert code == 400 and "error" in out


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(url(server, "/nope"), timeout=30)
    assert exc.value.code == 404


def test_only_the_paged_continuous_mode_is_served():
    with pytest.raises(ValueError, match="later slices"):
        serve(TCFG, PARAMS, port=0, continuous=False, device="cpu")
    with pytest.raises(SystemExit):
        main(["--kv-layout", "paged", "--init-seed", "0"])


def test_healthz_ands_the_external_verdict():
    srv = serve(TCFG, PARAMS, port=0, slots=1, page_size=8, device="cpu",
                health=lambda: (False, "chip reports unhealthy"))
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url(srv, "/healthz"), timeout=30)
        assert exc.value.code == 503
        assert exc.value.read() == b"chip reports unhealthy"
    finally:
        srv.shutdown()
