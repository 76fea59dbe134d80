"""HTTP front end of the PyTorch port (tpu_dra_torch/workloads/serve.py)
on the CPU: /healthz, /stats and /generate over the continuous engine in
both KV layouts, the serving weight forms, and the command line serving
an int8 npz."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import assert_greedy_agrees, cfg_pair, jax_params, to_torch

from tpu_dra_torch.convert import save_npz
from tpu_dra_torch.workloads import decode as td
from tpu_dra_torch.workloads.quant import quantize_params_int8
from tpu_dra_torch.workloads.serve import load_params, main, serve

ROOT = Path(__file__).resolve().parent.parent

JCFG, TCFG = cfg_pair(vocab=96, d_model=64, n_heads=4, n_kv_heads=2,
                   n_layers=2, d_ff=128, max_seq=64, pos_emb="rope")
PARAMS = to_torch(jax_params(JCFG, seed=3))


@pytest.fixture(scope="module")
def server():
    srv = serve(TCFG, PARAMS, port=0, slots=4, chunk=2, page_size=8,
                device="cpu", kv_layout="paged")
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


def oracle_agrees(params, prompt, steps, got):
    """``got`` follows the port's ``greedy_decode`` up to a near-tie."""
    want = td.greedy_decode(TCFG, params, torch.tensor([prompt]),
                            steps=steps, max_len=64)[0].tolist()
    cache = td.init_kv_cache(TCFG, 1, 64, device="cpu")
    cache, logits = td.prefill(TCFG, params, cache, torch.tensor([prompt]))
    lg = [logits[0].float().numpy()]
    for i, tok in enumerate(want[:-1]):
        logits, cache = td._token_logits(
            TCFG, params, cache, len(prompt) + i,
            torch.tensor([tok], dtype=torch.int32))
        lg.append(logits[0].float().numpy())
    return assert_greedy_agrees(want, np.stack(lg), got)


def test_slab_server_with_int8_weights():
    """The default layout (the slab) over int8 weights: each row follows
    the port's greedy_decode, and equals the same request through the
    engine."""
    params = quantize_params_int8(PARAMS)
    srv = serve(TCFG, params, port=0, slots=4, chunk=2, device="cpu")
    try:
        rows = [[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9], [42]]
        code, out = post(srv, "/generate", {"tokens": rows, "steps": 6})
        assert code == 200
        st = srv.engine.stats()
        assert st["kv_layout"] == "slab" and "kv_pages_total" not in st
        for r, toks in zip(rows, out["tokens"]):
            assert len(toks) == 6
            oracle_agrees(params, r, 6, toks)
            assert srv.engine.submit(r, 6, timeout=120) == toks
    finally:
        srv.shutdown()


def test_load_params_forms_and_a_quantized_npz(tmp_path):
    path = tmp_path / "w.npz"
    save_npz(path, PARAMS)
    for form, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        p = load_params(TCFG, params_npz=str(path), weights=form,
                        device="cpu")
        assert p["blocks"]["wqkv"].dtype == dtype
    p4 = load_params(TCFG, params_npz=str(path), weights="int4",
                     device="cpu")
    assert sorted(p4["blocks"]["w1"]) == ["q4", "s4"]
    q = quantize_params_int8(PARAMS)
    save_npz(tmp_path / "q.npz", q)
    served = load_params(TCFG, params_npz=str(tmp_path / "q.npz"),
                         weights="int8", device="cpu")
    assert torch.equal(served["unembed"]["q8"], q["unembed"]["q8"])
    assert served["unembed"]["s"].dtype == torch.float32  # not re-cast
    with pytest.raises(ValueError, match="holds int8"):
        load_params(TCFG, params_npz=str(tmp_path / "q.npz"),
                    weights="bf16", device="cpu")
    with pytest.raises(ValueError, match="weights must be"):
        load_params(TCFG, init_seed=0, weights="int2", device="cpu")


def test_cli_serves_an_int8_npz_on_the_cpu(tmp_path):
    """``python -m tpu_dra_torch.workloads.serve --continuous --params-npz
    w.npz --weights int8 --device cpu``: the served tokens follow the
    port's greedy_decode over the same int8 weights; SIGTERM drains and
    exits 0."""
    path = tmp_path / "w.npz"
    save_npz(path, PARAMS)
    cmd = [sys.executable, "-m", "tpu_dra_torch.workloads.serve",
           "--continuous", "--params-npz", str(path), "--weights", "int8",
           "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
           "--vocab", "96", "--d-model", "64", "--n-heads", "4",
           "--n-kv-heads", "2", "--n-layers", "2", "--d-ff", "128",
           "--max-seq", "64", "--slots", "2", "--chunk", "2"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        while "serving on" not in line:
            line = proc.stdout.readline()
            assert line, "the server exited before serving"
        port = int(re.search(r", (\d+)\)", line).group(1))
        body = json.dumps({"tokens": [[3, 1, 4, 1, 5]], "steps": 5}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            toks = json.loads(resp.read())["tokens"][0]
    finally:
        proc.terminate()
        rc = proc.wait(timeout=60)
    assert rc == 0
    oracle_agrees(quantize_params_int8(PARAMS), [3, 1, 4, 1, 5], 5, toks)
