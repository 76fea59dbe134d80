"""KV handoff of the PyTorch port (tpu_dra_torch/workloads/kv_handoff.py,
``ContinuousEngine.submit_handoff``, the server's /prefill and
/decode_handoff) on the CPU: each test of tests/test_kv_handoff.py on the
port, at its tiny config, then the two packages against each other.

The contract is byte-identity: export → wire blob → import decodes
exactly the tokens one engine decodes for the same request, greedy,
sampled and on an int8 pool.  Across the packages a blob's bytes are the
same whichever wrote it, the two exporters agree within bf16 rounding,
and a blob of either package decodes in the other's engine to greedy
tokens that agree under the near-tie rule.
"""

from __future__ import annotations

import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from torch_parity import (
    assert_greedy_agrees,
    cfg_pair,
    f32,
    jax_params,
    jax_stream,
    logit_tol,
    ragged_case,
    to_torch,
)

from tpu_dra.workloads import kv_handoff as jkv
from tpu_dra.workloads.continuous import ContinuousEngine as JaxEngine
from tpu_dra_torch.workloads import kv_handoff
from tpu_dra_torch.workloads.collective_matmul import ring_shift_ref
from tpu_dra_torch.workloads.continuous import ContinuousEngine, prompt_bucket
from tpu_dra_torch.workloads.kv_handoff import (
    KVHandoff,
    PrefillExporter,
    decode_blob,
    encode,
    model_dims,
    peek_prompt_len,
)
from tpu_dra_torch.workloads.serve import serve

CFG_KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_seq=64, pos_emb="rope")
JCFG, CFG = cfg_pair(**CFG_KW)
JPARAMS = jax_params(JCFG)
PARAMS = to_torch(JPARAMS)
WAIT = 120
# the two exporters round at the same points in another summation order:
# a third of their bf16 KV elements land an ulp or two apart after two
# layers (at most 0.0234 at magnitudes up to 3.4 on these prompts, where
# an ulp is 2^-6), held to 2^-5 absolute plus 2^-6 relative; the fp32
# logits within logit_tol of each other
KV_TOL = dict(rtol=2 ** -6, atol=2 ** -5)


def _engine(params=PARAMS, cfg=CFG, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("chunk", 2)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("page_size", 8)
    return ContinuousEngine(cfg, params, device="cpu", **kw)


def _exporter(params=PARAMS, cfg=CFG, page_size=8):
    return PrefillExporter(cfg, params, page_size=page_size, device="cpu")


def _wait(req):
    assert req.done.wait(WAIT)
    assert req.error is None, req.error
    return req.tokens


# --------------------------------------------------------------------------
# wire format
# --------------------------------------------------------------------------


def test_blob_round_trip():
    h = _exporter().export([3, 5, 7])
    assert h.ks.dtype == torch.bfloat16 and h.ks.device.type == "cpu"
    assert h.ks.shape == (2, 1, 2, 16, 16)     # bucket 16, two pages
    assert h.last_logits.dtype == torch.float32
    back = decode_blob(encode(h))
    assert back.prompt == [3, 5, 7]
    assert back.length == 3
    assert back.page_size == 8
    assert back.model == model_dims(CFG)
    assert torch.equal(back.ks, h.ks) and torch.equal(back.vs, h.vs)
    assert back.ks.dtype == torch.bfloat16
    assert torch.equal(back.last_logits, h.last_logits)
    assert back.pages() == 1


@pytest.mark.parametrize("mutate", [
    lambda b: b"XXXX" + b[4:],                 # bad magic
    lambda b: b[:40],                          # truncated
    lambda b: b[:4] + b"\xff\xff\xff\x7f" + b[8:],   # absurd header len
])
def test_blob_rejects_malformed(mutate):
    blob = encode(_exporter().export([1]))
    with pytest.raises(ValueError):
        decode_blob(mutate(blob))


# --------------------------------------------------------------------------
# byte-identity: one engine vs prefill engine -> decode engine
# --------------------------------------------------------------------------


def _single_engine_tokens(prompt, steps, cache_dtype="bf16", **submit_kw):
    eng = _engine(cache_dtype=cache_dtype)
    try:
        return eng.submit(list(prompt), steps, timeout=WAIT, **submit_kw)
    finally:
        eng.shutdown()


def _handoff_tokens(prompt, steps, *, cache_dtype="bf16", **submit_kw):
    blob = encode(_exporter().export(list(prompt)))   # the full wire trip
    eng = _engine(cache_dtype=cache_dtype)
    try:
        return _wait(eng.submit_handoff(decode_blob(blob), steps,
                                        **submit_kw))
    finally:
        eng.shutdown()


def test_handoff_decode_byte_identical_greedy():
    prompt, steps = [3, 5, 7, 11, 13], 10
    single = _single_engine_tokens(prompt, steps)
    disagg = _handoff_tokens(prompt, steps)
    assert disagg == single
    assert len(disagg) == steps


def test_handoff_decode_byte_identical_sampled():
    # the first token draws from the blob's logits with the request's own
    # generator, seeded as a local admission seeds it
    kw = dict(temperature=0.8, seed=42)
    single = _single_engine_tokens([2, 4, 6], 8, **kw)
    assert _handoff_tokens([2, 4, 6], 8, **kw) == single


def test_handoff_eos_and_multi_page_prompt():
    # an 11-token prompt spans two 8-token pages; eos rides through
    prompt = list(range(1, 12))
    single = _single_engine_tokens(prompt, 12, eos_id=9)
    assert _handoff_tokens(prompt, 12, eos_id=9) == single


def test_handoff_into_int8_pool_matches_int8_single_engine():
    # the wire carries bf16; an int8 pool quantizes at page write as its
    # own prefill does
    prompt, steps = [3, 1, 4, 1, 5], 8
    single = _single_engine_tokens(prompt, steps, cache_dtype="int8")
    assert _handoff_tokens(prompt, steps, cache_dtype="int8") == single


def test_handoff_pages_return_to_pool():
    eng = _engine()
    try:
        baseline = eng.pool.free_pages
        _wait(eng.submit_handoff(_exporter().export([1, 2, 3]), 4))
        # retirement frees the slot's pages at the pass boundary
        ev = threading.Event()
        for _ in range(100):
            if eng.pool.free_pages == baseline:
                break
            ev.wait(0.05)
        assert eng.pool.free_pages == baseline
    finally:
        eng.shutdown()


def test_handoff_concurrent_with_local_requests():
    """Handoff admissions interleave with local prefill admissions in one
    engine without perturbing either."""
    exp = _exporter()
    single_a = _single_engine_tokens([7, 8, 9], 6)
    single_b = _single_engine_tokens([10, 11], 6)
    eng = _engine(slots=4)
    try:
        ha = eng.submit_handoff(exp.export([7, 8, 9]), 6)
        hb = eng.submit_async([10, 11], 6)
        assert _wait(ha) == single_a
        assert _wait(hb) == single_b
    finally:
        eng.shutdown()


# --------------------------------------------------------------------------
# HTTP: /prefill on one server -> /decode_handoff on another
# --------------------------------------------------------------------------


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def _code(port, path, payload) -> int:
    try:
        _post(port, path, payload)
    except urllib.error.HTTPError as exc:
        exc.read()
        return exc.code
    return 200


PAGED = dict(continuous=True, slots=2, chunk=2, kv_layout="paged",
             page_size=8, device="cpu")


def test_http_prefill_to_decode_handoff_matches_single_generate():
    """The router's two hops: /prefill on a prefill-pool server, then
    /decode_handoff with the blob on a decode-pool server; the answer is
    one server's /generate.  Both roles are advertised."""
    prefill = serve(CFG, PARAMS, port=0, pool_role="prefill", **PAGED)
    decode = serve(CFG, PARAMS, port=0, pool_role="decode", **PAGED)
    try:
        pport = prefill.server_address[1]
        dport = decode.server_address[1]
        prompt, steps = [3, 5, 7, 11], 8
        single = _post(dport, "/generate",
                       {"tokens": [prompt], "steps": steps})["tokens"][0]
        pre = _post(pport, "/prefill", {"tokens": prompt})
        assert pre["length"] == len(prompt)
        out = _post(dport, "/decode_handoff",
                    {"blob": pre["blob"], "prompt_len": pre["length"],
                     "steps": steps})
        assert out["tokens"][0] == single
        for port, want in ((pport, "prefill"), (dport, "decode")):
            assert _get(port, "/debug/overload")["role"] == want
        # /prefill takes one sequence; the router fans the rows
        assert _code(pport, "/prefill", {"tokens": [[1], [2]]}) == 400
    finally:
        prefill.shutdown()
        decode.shutdown()


def test_http_decode_handoff_rejects_garbage_blob():
    srv = serve(CFG, PARAMS, port=0, **PAGED)
    try:
        port = srv.server_address[1]
        for payload in ({"blob": "not base64!!", "steps": 2},
                        {"blob": "QUJDRA==", "steps": 2}):   # bad magic
            assert _code(port, "/decode_handoff", payload) == 400
        assert _get(port, "/debug/overload")["role"] == "any"
    finally:
        srv.shutdown()


def test_http_handoff_needs_paged_engine():
    """A slab engine answers neither endpoint (400), and an unknown role
    is the reference's ValueError."""
    srv = serve(CFG, PARAMS, port=0, continuous=True, slots=2, chunk=2,
                device="cpu")
    try:
        port = srv.server_address[1]
        assert _code(port, "/prefill", {"tokens": [1, 2]}) == 400
        assert _code(port, "/decode_handoff", {"blob": "", "steps": 2}) \
            == 400
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="pool_role must be"):
        serve(CFG, PARAMS, port=0, pool_role="both", **PAGED)


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


def test_handoff_model_mismatch_rejected():
    jother, other = cfg_pair(**dict(CFG_KW, n_layers=1))
    h = _exporter(to_torch(jax_params(jother, seed=1)), other).export([1, 2])
    eng = _engine()
    try:
        with pytest.raises(ValueError, match="different model"):
            eng.submit_handoff(h, 4)
    finally:
        eng.shutdown()


def test_handoff_page_size_mismatch_rejected():
    h = _exporter(page_size=16).export([1, 2])
    eng = _engine()                     # page_size 8
    try:
        with pytest.raises(ValueError, match="page_size"):
            eng.submit_handoff(h, 4)
    finally:
        eng.shutdown()


def test_handoff_requires_paged_engine():
    h = _exporter().export([1, 2])
    eng = _engine(kv_layout="slab")
    try:
        with pytest.raises(ValueError, match="paged"):
            eng.submit_handoff(h, 4)
    finally:
        eng.shutdown()


def test_handoff_overlong_rejected():
    h = _exporter().export([1, 2, 3])
    eng = _engine()
    try:
        with pytest.raises(ValueError, match="max_len"):
            eng.submit_handoff(h, 64)
    finally:
        eng.shutdown()


def test_handoff_malformed_shapes_rejected_without_killing_engine():
    """A blob whose arrays do not fit the model fails the one request on
    the caller's thread; the engine keeps serving."""
    good = _exporter().export([1, 2, 3])
    eng = _engine()
    try:
        bad_kv = KVHandoff(
            prompt=[1], length=1, page_size=8, model=model_dims(CFG),
            ks=np.zeros((1, 1, 1, 8, 1), np.float32),
            vs=np.zeros((1, 1, 1, 8, 1), np.float32),
            last_logits=np.zeros((CFG.vocab,), np.float32))
        with pytest.raises(ValueError, match="KV shape"):
            eng.submit_handoff(bad_kv, 2)
        bad_cols = KVHandoff(
            prompt=list(good.prompt), length=good.length, page_size=8,
            model=model_dims(CFG), ks=good.ks[:, :, :, :5],
            vs=good.vs[:, :, :, :5],          # not a page multiple
            last_logits=good.last_logits)
        with pytest.raises(ValueError, match="page multiple"):
            eng.submit_handoff(bad_cols, 2)
        bad_logits = KVHandoff(
            prompt=list(good.prompt), length=good.length, page_size=8,
            model=model_dims(CFG), ks=good.ks, vs=good.vs,
            last_logits=np.zeros((3,), np.float32))
        with pytest.raises(ValueError, match="last_logits"):
            eng.submit_handoff(bad_logits, 2)
        bad_dtype = KVHandoff(
            prompt=list(good.prompt), length=good.length, page_size=8,
            model=model_dims(CFG),
            ks=np.full(tuple(good.ks.shape), "x", object),
            vs=np.full(tuple(good.vs.shape), "x", object),
            last_logits=good.last_logits)
        with pytest.raises(ValueError, match="not numeric"):
            eng.submit_handoff(bad_dtype, 2)
        # every rejection left the engine serving
        _wait(eng.submit_handoff(good, 4))
        assert eng.healthy()[0]
    finally:
        eng.shutdown()


def test_http_lying_shape_is_a_400_and_the_engine_serves_on():
    """A blob whose header lies about the KV's shape (a consistent blob
    of the wrong layout) 400s at /decode_handoff; the next request is
    answered."""
    srv = serve(CFG, PARAMS, port=0, **PAGED)
    try:
        port = srv.server_address[1]
        good = _exporter().export([4, 5, 6])
        lie = KVHandoff(prompt=good.prompt, length=good.length, page_size=8,
                        model=good.model, ks=good.ks[:, :, :1],
                        vs=good.vs[:, :, :1], last_logits=good.last_logits)
        blob = base64.b64encode(encode(lie)).decode()
        assert _code(port, "/decode_handoff", {"blob": blob, "steps": 3}) \
            == 400
        blob = base64.b64encode(encode(good)).decode()
        out = _post(port, "/decode_handoff", {"blob": blob, "steps": 3})
        assert len(out["tokens"][0]) == 3
    finally:
        srv.shutdown()


def test_peek_prompt_len_reads_header_without_arrays():
    """Admission prices /decode_handoff from the blob's own header: the
    true length from a few base64 characters, None for garbage."""
    h = _exporter().export(list(range(1, 12)))
    blob_b64 = base64.b64encode(encode(h)).decode()
    assert peek_prompt_len(blob_b64) == 11
    assert peek_prompt_len("") is None
    assert peek_prompt_len("not base64!!") is None
    assert peek_prompt_len(
        base64.b64encode(b"XXXXjunkjunkjunk").decode()) is None
    assert peek_prompt_len(None) is None


def test_handoff_not_a_kvhandoff_rejected():
    eng = _engine()
    try:
        with pytest.raises(ValueError, match="KVHandoff"):
            eng.submit_handoff({"ks": 1}, 4)
    finally:
        eng.shutdown()


def test_handoff_refused_by_a_speculative_engine():
    eng = _engine(chunk=2, draft=(CFG, PARAMS))
    try:
        with pytest.raises(ValueError, match="speculative engines"):
            eng.submit_handoff(_exporter().export([1, 2]), 4)
    finally:
        eng.shutdown()


# --------------------------------------------------------------------------
# The in-mesh path
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n, max_len, want", [
    (1, 64, 16), (16, 64, 16), (17, 64, 32), (40, 48, 48), (300, 1024, 512)])
def test_prompt_bucket_clamps_to_max_len(n, max_len, want):
    assert prompt_bucket(n, max_len) == want


def test_exporter_pads_the_clamped_bucket_to_pages():
    """The exporter takes the engine's bucket, clamped to max_len, then
    pads to a page multiple; the handoff decodes as one engine of that
    max_len does."""
    exp = PrefillExporter(CFG, PARAMS, page_size=8, max_len=40,
                          device="cpu")
    prompt = list(range(1, 34))
    h = exp.export(prompt)
    assert h.ks.shape[3] == 40 and h.vs.shape[3] == 40
    eng = _engine(max_len=40)
    try:
        local = _wait(eng.submit_async(prompt, 6))
        handed = _wait(eng.submit_handoff(h, 6))
    finally:
        eng.shutdown()
    assert handed == local


def test_ici_shift_matches_the_reference_under_shard_map():
    """The port's shift of a handoff's pages on a two-rank ring ([1, 2,
    ...] blocks) equals the reference's ici_shift under shard_map in
    interpret mode, each direction, and ring_shift_ref."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from tpu_dra.workloads.ring_attention import shard_map

    h = _exporter().export([3, 1, 4, 1, 5])
    x = torch.stack([h.ks[:, 0], h.vs[:, 0]]).float()   # [2, L, Hkv, S, D]
    mesh = Mesh(np.array(jax.devices()[:2]), ("h",))
    for reverse in (False, True):
        f = shard_map(
            lambda t, r=reverse: jkv.ici_shift(t, "h", reverse=r,
                                               interpret=True),
            mesh=mesh, in_specs=P("h"), out_specs=P("h"))
        want = np.asarray(jax.jit(f)(x.numpy()))
        got = kv_handoff.ici_shift({"kv": x[None]}, reverse=reverse)
        np.testing.assert_array_equal(got["kv"][0].numpy(), want)
        assert torch.equal(got["kv"], ring_shift_ref(x[None], reverse))
    np.testing.assert_array_equal(want[0], x[1].numpy())


# --------------------------------------------------------------------------
# Across the packages
# --------------------------------------------------------------------------


def _jax_export(prompt, page_size=8):
    return jkv.PrefillExporter(JCFG, JPARAMS, page_size=page_size).export(
        list(prompt))


def test_blobs_cross_between_the_packages_bit_equal():
    """A reference blob decodes in the port to the same array bits and
    re-encodes to the same bytes, and a port blob likewise in the
    reference."""
    ref = jkv.encode(_jax_export(list(range(1, 12))))
    got = decode_blob(ref)
    want = jkv.decode_blob(ref)
    for name in ("ks", "vs"):
        np.testing.assert_array_equal(
            getattr(got, name).view(torch.int16).numpy(),
            np.asarray(getattr(want, name)).view(np.int16))
    np.testing.assert_array_equal(got.last_logits.numpy(),
                                  np.asarray(want.last_logits))
    assert encode(got) == ref
    mine = encode(_exporter().export(list(range(1, 12))))
    back = jkv.decode_blob(mine)
    assert back.model == model_dims(CFG) and back.length == 11
    assert np.asarray(back.ks).dtype.name == "bfloat16"
    assert jkv.encode(back) == mine


@pytest.mark.parametrize("via", ["wire", "ici", "auto"])
def test_transfer_gives_the_reference_bytes_on_every_via(via):
    """``transfer`` serializes on every ``via``, as the reference's does:
    a reference handoff crossed into the port transfers to the bytes the
    reference's ``transfer`` gives it."""
    ref = _jax_export(list(range(1, 12)))
    want = jkv.transfer(ref, via=via)
    assert kv_handoff.transfer(decode_blob(jkv.encode(ref)), via=via) == want
    assert want == jkv.encode(ref)


@pytest.mark.parametrize("via", ["dma", "", "WIRE"])
def test_transfer_refuses_an_unknown_via(via):
    h = _exporter().export([1, 2, 3])
    with pytest.raises(ValueError, match="via"):
        kv_handoff.transfer(h, via=via)
    with pytest.raises(ValueError, match="via"):
        jkv.transfer(h, via=via)


def test_ici_is_not_supported_without_several_cards():
    """Here (no CUDA, as the reference's gate sees no TPU) the in-mesh
    hop is closed in both packages."""
    assert kv_handoff.ici_supported() is False
    assert jkv.ici_supported() is False


@pytest.mark.parametrize("prompt", [[3, 5, 7], list(range(1, 12)),
                                    list(range(5, 40))])
def test_exporters_agree_within_bf16(prompt):
    """The port's exporter and the reference's: the same columns (bucket
    and page padding) and the same KV and logits within bf16 rounding."""
    want = _jax_export(prompt)
    got = _exporter().export(prompt)
    assert tuple(got.ks.shape) == np.asarray(want.ks).shape
    for name in ("ks", "vs"):
        np.testing.assert_allclose(f32(getattr(got, name)),
                                   f32(getattr(want, name)), **KV_TOL)
    w = f32(want.last_logits)
    np.testing.assert_allclose(f32(got.last_logits), w, rtol=0,
                               atol=float(logit_tol(np.abs(w).max())))


def _reference_single(prompt, steps):
    """The reference's single paged engine's greedy tokens of ``prompt``,
    and the reference logits that chose each one (its paged decode fed
    those tokens)."""
    eng = JaxEngine(JCFG, JPARAMS, slots=2, chunk=2, kv_layout="paged",
                    page_size=8)
    try:
        toks = eng.submit(list(prompt), steps, timeout=WAIT)
    finally:
        eng.shutdown()
    p, lengths, table = ragged_case([prompt], steps, 8, 32)
    _, logits = jax_stream(JCFG, JPARAMS, p, lengths, table, steps,
                           page_size=8, total_pages=32,
                           forced=np.asarray([toks], np.int32))
    return toks, logits[:, 0]


@pytest.mark.parametrize("direction", ["reference blob, port engine",
                                       "port blob, reference engine"])
def test_blobs_decode_across_the_packages(direction):
    """A reference blob decoded by the port's engine gives greedy tokens
    that agree with the reference's single engine under the near-tie
    rule, and a port blob decoded by the reference's engine too."""
    prompt, steps = list(range(3, 17)), 10
    want_toks, want_logits = _reference_single(prompt, steps)
    if direction.startswith("reference"):
        eng = _engine()
        blob = decode_blob(jkv.encode(_jax_export(prompt)))
    else:
        eng = JaxEngine(JCFG, JPARAMS, slots=2, chunk=2, kv_layout="paged",
                        page_size=8)
        blob = jkv.decode_blob(encode(_exporter().export(prompt)))
    try:
        got = _wait(eng.submit_handoff(blob, steps))
    finally:
        eng.shutdown()
    assert len(got) == steps
    assert_greedy_agrees(want_toks, want_logits, got)
