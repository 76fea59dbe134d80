"""The reference's router (tpu_dra/workloads/router.py, JAX-free) in front
of one PyTorch replica and one JAX replica of the same model: the tiny
config with the slab continuous engine on both sides, the port's weights
converted from the reference's init.  Every greedy /generate request gets
the same answer from both replicas through the router, and a
``traceparent`` sent to the router resolves on the port replica's
/debug/traces: one trace id spans client, router and replica."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import pytest

from torch_parity import cfg_pair, jax_params, to_torch

from tpu_dra.workloads.router import Replica, Router, serve_router
from tpu_dra.workloads.serve import serve as jax_serve
from tpu_dra_torch.workloads.serve import serve

# tests/test_torch_serve_front.py's model: the scaled tied embedding
# spreads logit gaps past bf16 noise
JCFG, TCFG = cfg_pair(vocab=96, d_model=64, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=128, max_seq=64, pos_emb="rope",
                      tied_embeddings=True)
JPARAMS = jax_params(JCFG, seed=3, embed_scale=4.0)
PARAMS = to_torch(JPARAMS)
ENGINE = dict(continuous=True, slots=2, chunk=2, kv_layout="slab")
REQUESTS = [([3, 1, 4], 6), ([1, 5, 9, 2, 6], 8), ([5], 5), ([3, 5, 8], 4),
            ([9, 7, 9, 3, 2, 3, 8], 6), ([4, 6], 7), ([2, 6, 4, 3], 5),
            ([8, 3, 2, 7, 9], 6)]
WAIT = 120


def base(srv) -> str:
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}"


def post(url, body, headers=None):
    req = urllib.request.Request(
        f"{url}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())["tokens"]


def served_by(router) -> dict:
    return {lv[0]: v for lv, v in
            router.metrics.replica_requests.totals().items()}


@pytest.fixture(scope="module")
def fleet():
    port_srv = serve(TCFG, PARAMS, port=0, device="cpu", **ENGINE)
    jax_srv = jax_serve(JCFG, JPARAMS, port=0, **ENGINE)
    router = Router(probe_interval_s=0.2)
    reps = {"port": Replica(name="port", url=base(port_srv)),
            "jax": Replica(name="jax", url=base(jax_srv))}
    for rep in reps.values():
        router.add_replica(rep)
    rsrv = serve_router(router)
    deadline = time.monotonic() + 30
    while not all(r.routable() and r.signals for r in reps.values()):
        assert time.monotonic() < deadline, "replicas never probed healthy"
        time.sleep(0.1)
    yield router, reps, base(rsrv), base(port_srv)
    rsrv.shutdown()
    port_srv.shutdown()
    jax_srv.shutdown()


def only(router, reps, name):
    """Route to replica ``name`` alone (the other leaves the registry)."""
    for other, rep in reps.items():
        router.remove_replica(other)
    rep = Replica(name=name, url=reps[name].url)
    router.add_replica(rep)
    reps[name] = rep


def test_both_replicas_answer_every_request_alike(fleet):
    """Each request through the router once with both replicas
    registered, then once through it to each replica alone: the three
    answers are one."""
    router, reps, url, _ = fleet
    first = [post(url, {"tokens": [p], "steps": n}) for p, n in REQUESTS]
    assert sum(served_by(router).values()) == len(REQUESTS)
    answers = {}
    for name in ("port", "jax"):
        only(router, reps, name)
        before = served_by(router).get(name, 0)
        answers[name] = [post(url, {"tokens": [p], "steps": n})
                         for p, n in REQUESTS]
        assert served_by(router)[name] - before == len(REQUESTS)
    assert answers["port"] == answers["jax"] == first
    assert all(len(a[0]) == n for a, (_, n) in zip(first, REQUESTS))


def test_traceparent_resolves_on_the_port_replica(fleet):
    router, reps, url, port_url = fleet
    only(router, reps, "port")
    trace_id = "5e" * 16
    post(url, {"tokens": [[3, 1, 4]], "steps": 3},
         headers={"traceparent": f"00-{trace_id}-{'2f' * 8}-01"})
    try:
        with urllib.request.urlopen(
                f"{port_url}/debug/traces?trace_id={trace_id}",
                timeout=30) as r:
            events = json.loads(r.read())["traceEvents"]
    except urllib.error.HTTPError as exc:
        raise AssertionError(exc.read()) from None
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"serve.request", "serve.engine.decode"} <= names
