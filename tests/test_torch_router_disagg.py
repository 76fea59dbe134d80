"""Disaggregated serving through the reference's router
(tpu_dra/workloads/router.py, JAX-free, ``disaggregate=True``) with the
port's replicas: a port ``role=prefill`` replica exports each row's KV
(/prefill) and a port ``role=decode`` replica decodes it
(/decode_handoff).  Every /generate through the router equals a single
port engine's answer, and the router counts each handoff.  Then the
packages mix: a reference prefill replica in front of a port decode
replica, and the reverse; their greedy answers agree with the reference's
single engine under the near-tie rule."""

from __future__ import annotations

import json
import time
import urllib.request

import numpy as np
import pytest

from torch_parity import (
    assert_greedy_agrees,
    cfg_pair,
    jax_params,
    jax_stream,
    ragged_case,
    to_torch,
)

from tpu_dra.workloads.continuous import ContinuousEngine as JaxEngine
from tpu_dra.workloads.router import (
    ROLE_DECODE,
    ROLE_PREFILL,
    Replica,
    Router,
    serve_router,
)
from tpu_dra.workloads.serve import serve as jax_serve
from tpu_dra_torch.workloads.continuous import ContinuousEngine
from tpu_dra_torch.workloads.serve import serve

# tests/test_torch_router_mixed.py's model: the scaled tied embedding
# spreads logit gaps past bf16 noise
JCFG, TCFG = cfg_pair(vocab=96, d_model=64, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=128, max_seq=64, pos_emb="rope",
                      tied_embeddings=True)
JPARAMS = jax_params(JCFG, seed=3, embed_scale=4.0)
PARAMS = to_torch(JPARAMS)
PAGED = dict(continuous=True, slots=2, chunk=2, kv_layout="paged",
             page_size=8)
REQUESTS = [([3, 1, 4], 6), ([1, 5, 9, 2, 6], 8), ([5], 5),
            ([9, 7, 9, 3, 2, 3, 8, 4, 6, 2, 6, 4, 3, 3, 8, 3, 2, 7], 6),
            ([4, 6], 7), ([2, 6, 4, 3], 5)]
WAIT = 120


def base(srv) -> str:
    host, port = srv.server_address[:2]
    return f"http://{host}:{port}"


def post(url, body):
    req = urllib.request.Request(
        f"{url}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return json.loads(r.read())["tokens"]


def start(kind: str, role: str):
    if kind == "port":
        return serve(TCFG, PARAMS, port=0, device="cpu", pool_role=role,
                     **PAGED)
    return jax_serve(JCFG, JPARAMS, port=0, pool_role=role, **PAGED)


def through_router(prefill_kind: str, decode_kind: str) -> tuple:
    """Each request of REQUESTS as one /generate through a disaggregating
    router over a ``prefill_kind`` prefill replica and a ``decode_kind``
    decode replica; returns (answers, the router's handoff counts)."""
    pre, dec = start(prefill_kind, "prefill"), start(decode_kind, "decode")
    router = Router(probe_interval_s=0.2, disaggregate=True)
    router.add_replica(Replica(name="pre", url=base(pre), role=ROLE_PREFILL))
    router.add_replica(Replica(name="dec", url=base(dec), role=ROLE_DECODE))
    rsrv = serve_router(router)
    try:
        deadline = time.monotonic() + 30
        while not (router._view_prefill and router._view_decode):
            assert time.monotonic() < deadline, "pools never came up"
            time.sleep(0.05)
        answers = [post(base(rsrv), {"tokens": [p], "steps": n})[0]
                   for p, n in REQUESTS]
        # a request of two rows fans out into two handoffs
        two = post(base(rsrv), {"tokens": [REQUESTS[0][0], REQUESTS[4][0]],
                                "steps": 5})
        counts = {lv[0]: v for lv, v in
                  router.metrics.handoffs.totals().items()}
    finally:
        rsrv.shutdown()
        pre.shutdown()
        dec.shutdown()
    assert [len(t) for t in two] == [5, 5]
    return answers, counts


def test_port_pools_answer_as_one_port_engine():
    answers, counts = through_router("port", "port")
    eng = ContinuousEngine(TCFG, PARAMS, slots=2, chunk=2,
                           kv_layout="paged", page_size=8, device="cpu")
    try:
        want = [eng.submit(p, n, timeout=WAIT) for p, n in REQUESTS]
    finally:
        eng.shutdown()
    assert answers == want
    assert counts == {"ok": len(REQUESTS) + 2}


def reference_single(prompt, steps):
    """The reference single engine's greedy tokens and the reference
    logits that chose each one."""
    eng = JaxEngine(JCFG, JPARAMS, slots=2, chunk=2, kv_layout="paged",
                    page_size=8)
    try:
        toks = eng.submit(list(prompt), steps, timeout=WAIT)
    finally:
        eng.shutdown()
    p, lengths, table = ragged_case([prompt], steps, 8, 16)
    _, logits = jax_stream(JCFG, JPARAMS, p, lengths, table, steps,
                           page_size=8, total_pages=16,
                           forced=np.asarray([toks], np.int32))
    return toks, logits[:, 0]


@pytest.mark.parametrize("kinds", [("reference", "port"),
                                   ("port", "reference")],
                         ids=["reference prefill, port decode",
                              "port prefill, reference decode"])
def test_mixed_pools_agree_with_the_reference(kinds):
    answers, counts = through_router(*kinds)
    assert counts == {"ok": len(REQUESTS) + 2}
    for (prompt, steps), got in zip(REQUESTS, answers):
        assert len(got) == steps
        assert_greedy_agrees(*reference_single(prompt, steps), got)
