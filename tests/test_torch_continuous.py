"""Continuous engine of the PyTorch port
(tpu_dra_torch/workloads/continuous.py) on the CPU, in both KV layouts:
its greedy tokens against the port's own per-request decoders and the
JAX engine (bf16 and int8 weights on the slab), the scheduling contracts
(no head-of-line blocking, FIFO page gate, pages back to the pool, slab
writes past the end dropped), sampling, and the features left for later
slices.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from torch_parity import (
    assert_greedy_agrees,
    cfg_pair,
    jax_params,
    jax_stream,
    port_forced_logits,
    ragged_case,
    to_torch,
)

from tpu_dra.workloads import decode as jd
from tpu_dra.workloads import quant as jq
from tpu_dra.workloads.continuous import ContinuousEngine as JaxEngine
from tpu_dra_torch.workloads import decode as td
from tpu_dra_torch.workloads import paged_kv as tpk
from tpu_dra_torch.workloads.continuous import (
    DEADLINE_ERROR,
    ContinuousEngine,
    gumbel_noise,
    select_tokens,
)

CFG_KW = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=128, max_seq=64, pos_emb="rope", tied_embeddings=True)
JCFG, TCFG = cfg_pair(**CFG_KW)
# the tied embedding scaled up spreads random-init logit gaps past bf16
# noise, as tests/test_continuous_paged.py does for the reference engine
JPARAMS = jax_params(JCFG, seed=0, embed_scale=4.0)
PARAMS = to_torch(JPARAMS)
ENGINE_KW = dict(slots=4, chunk=2, max_len=40, page_size=8, device="cpu",
                 kv_layout="paged")
WAIT = 120


@pytest.fixture()
def engine():
    eng = ContinuousEngine(TCFG, PARAMS, **ENGINE_KW)
    yield eng
    eng.shutdown()


def submit_all(eng, reqs):
    """Submit ``(prompt, steps)`` pairs concurrently; tokens in order."""
    handles = [eng.submit_async(p, s) for p, s in reqs]
    for h in handles:
        assert h.done.wait(WAIT) and h.error is None, h.error
    return [h.tokens for h in handles]


REQS = [([3, 5, 7], 7), ([2, 4], 9), ([11, 12, 13, 14, 15], 4),
        ([9] * 12, 6), ([1], 5)]


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_greedy_equals_port_paged_greedy_decode(cache_dtype):
    """Every request's tokens equal the port's own per-request
    ``paged_greedy_decode`` (the engine's contract), up to a bf16
    near-tie that a different batch shape may break either way."""
    eng = ContinuousEngine(TCFG, PARAMS, cache_dtype=cache_dtype,
                           **ENGINE_KW)
    try:
        got = submit_all(eng, REQS)
    finally:
        eng.shutdown()
    for (prompt, steps), toks in zip(REQS, got):
        p, lengths, table = ragged_case([prompt], steps, 8, 16)
        want = tpk.paged_greedy_decode(
            TCFG, PARAMS, torch.from_numpy(p).long(),
            torch.from_numpy(table), steps=steps, total_pages=16,
            page_size=8, cache_dtype=cache_dtype)[0].numpy()
        want_lg = port_forced_logits(TCFG, PARAMS, p, lengths, table,
                                     want[None], page_size=8,
                                     total_pages=16,
                                     cache_dtype=cache_dtype)
        assert len(toks) == steps
        assert_greedy_agrees(want, want_lg[:, 0], toks)


def test_greedy_equals_jax_engine():
    """Same weights, same requests: the port's engine follows the JAX
    paged engine's greedy tokens, up to a reference near-tie."""
    steps = 6
    reqs = [(p, steps) for p, _ in REQS]
    jeng = JaxEngine(JCFG, JPARAMS, kv_layout="paged", slots=4, chunk=2,
                     max_len=40, page_size=8)
    try:
        want = [jeng.submit(p, s, timeout=WAIT) for p, s in reqs]
    finally:
        jeng.shutdown()
    eng = ContinuousEngine(TCFG, PARAMS, **ENGINE_KW)
    try:
        got = submit_all(eng, reqs)
    finally:
        eng.shutdown()
    prompt, lengths, table = ragged_case([p for p, _ in reqs], steps, 8, 40)
    _, want_lg = jax_stream(JCFG, JPARAMS, prompt, lengths, table, steps,
                            page_size=8, total_pages=40,
                            forced=np.asarray(want, np.int32))
    agreed = [assert_greedy_agrees(w, want_lg[:, b], g)
              for b, (w, g) in enumerate(zip(want, got))]
    assert sum(agreed) >= len(reqs) * steps // 2   # the check has teeth


# -------------------------------------------------------------------------
# The slab layout
# -------------------------------------------------------------------------

SLAB_KW = dict(ENGINE_KW, kv_layout="slab")
WEIGHTS = {"bf16": jq.cast_params_bf16, "int8": jq.quantize_params_int8}


def port_slab_logits(params, prompt, tokens, cache_dtype="bf16"):
    """The port's ``greedy_decode`` logits ``[steps, V]`` for one prompt
    when fed ``tokens`` (step i's logits follow tokens < i)."""
    cache = td.init_kv_cache(TCFG, 1, 40, cache_dtype, device="cpu")
    cache, logits = td.prefill(TCFG, params, cache, torch.tensor([prompt]))
    outs = [logits[0].float().numpy()]
    for i, tok in enumerate(tokens[:-1]):
        logits, cache = td._token_logits(
            TCFG, params, cache, len(prompt) + i,
            torch.tensor([tok], dtype=torch.int32))
        outs.append(logits[0].float().numpy())
    return np.stack(outs)


def jax_slab_logits(jparams, prompt, tokens):
    """The same for the reference's decoder."""
    cache = jd.init_kv_cache(JCFG, 1, 40)
    cache, logits = jd.prefill(JCFG, jparams, cache, np.asarray([prompt]))
    outs = [np.asarray(logits[0])]
    for i, tok in enumerate(tokens[:-1]):
        logits, cache = jd._token_logits(JCFG, jparams, cache,
                                         len(prompt) + i,
                                         np.asarray([tok], np.int32))
        outs.append(np.asarray(logits[0]))
    return np.stack(outs)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("weights", WEIGHTS)
def test_slab_greedy_equals_port_greedy_decode(weights, cache_dtype):
    """On the slab, every request's tokens equal the port's own
    per-request ``decode.greedy_decode``, up to a bf16 near-tie."""
    params = to_torch(WEIGHTS[weights](JPARAMS))
    eng = ContinuousEngine(TCFG, params, cache_dtype=cache_dtype, **SLAB_KW)
    try:
        got = submit_all(eng, REQS)
    finally:
        eng.shutdown()
    for (prompt, steps), toks in zip(REQS, got):
        want = td.greedy_decode(TCFG, params, torch.tensor([prompt]),
                                steps=steps, max_len=40,
                                cache_dtype=cache_dtype)[0].tolist()
        assert len(toks) == steps
        assert_greedy_agrees(want, port_slab_logits(params, prompt, want,
                                                    cache_dtype), toks)


@pytest.mark.parametrize("weights", WEIGHTS)
def test_slab_greedy_equals_jax_engine(weights):
    """Same serving tree, same requests: the port's slab engine follows
    the JAX slab engine's greedy tokens, up to a reference near-tie."""
    jparams = WEIGHTS[weights](JPARAMS)
    steps = 6
    reqs = [(p, steps) for p, _ in REQS]
    jeng = JaxEngine(JCFG, jparams, slots=4, chunk=2, max_len=40)
    try:
        want = [jeng.submit(p, s, timeout=WAIT) for p, s in reqs]
    finally:
        jeng.shutdown()
    eng = ContinuousEngine(TCFG, to_torch(jparams), **SLAB_KW)
    try:
        got = submit_all(eng, reqs)
    finally:
        eng.shutdown()
    agreed = sum(assert_greedy_agrees(w, jax_slab_logits(jparams, p, w), g)
                 for (p, _), w, g in zip(reqs, want, got))
    assert agreed >= len(reqs) * steps // 2       # the check has teeth


def test_slab_drops_writes_past_the_end_of_a_slot():
    """A request that fills its slot to max_len runs its last chunk past
    the end (9 decode steps in chunks of 4): those writes drop, and the
    next request in the same slot is served right."""
    params = to_torch(jq.quantize_params_int8(JPARAMS))
    eng = ContinuousEngine(TCFG, params, **dict(SLAB_KW, slots=1, chunk=4))
    reqs = [([5] * 30, 10), ([7, 8, 9], 6)]
    try:
        got = [eng.submit(p, s, timeout=WAIT) for p, s in reqs]
        st = eng.stats()
    finally:
        eng.shutdown()
    assert st["kv_layout"] == "slab" and "kv_pages_total" not in st
    assert st["completed"] == 2
    for (prompt, steps), toks in zip(reqs, got):
        want = td.greedy_decode(TCFG, params, torch.tensor([prompt]),
                                steps=steps, max_len=40)[0].tolist()
        assert_greedy_agrees(want, port_slab_logits(params, prompt, want),
                             toks)


def test_short_request_after_long_finishes_first(engine):
    order = []
    long_req = engine.submit_async([1, 2, 3], steps=30)

    def short():
        engine.submit([9, 8], steps=2, timeout=WAIT)
        order.append("short")

    t = threading.Thread(target=short)
    t.start()
    t.join(WAIT)
    assert order == ["short"]
    assert not long_req.done.is_set(), "long request finished first"
    assert long_req.done.wait(WAIT) and len(long_req.tokens) == 30


def test_pages_return_after_retirement_and_cancel():
    eng = ContinuousEngine(TCFG, PARAMS, slots=1, chunk=2, max_len=40,
                           page_size=8, total_pages=8, device="cpu",
                           kv_layout="paged")
    try:
        assert eng.submit([1, 2], 3, timeout=WAIT)
        assert eng.stats()["kv_pages_free"] == 8
        long_h = eng.submit_async([1, 2], 30)
        queued = eng.submit_async([3, 4], 3)
        eng.cancel(queued)                        # cancelled while queued
        deadline = time.time() + WAIT
        while time.time() < deadline and not long_h.tokens:
            time.sleep(0.01)
        assert eng.stats()["kv_pages_free"] < 8
        eng.cancel(long_h)                        # cancelled in flight
        assert long_h.done.wait(WAIT) and long_h.error == "cancelled"
        assert queued.done.wait(WAIT) and queued.error == "cancelled"
        deadline = time.time() + WAIT
        while time.time() < deadline and eng.stats()["kv_pages_free"] != 8:
            time.sleep(0.01)
        st = eng.stats()
        assert st["kv_pages_free"] == 8 and st["cancelled"] == 2
        assert st["completed"] == 1 and st["active"] == 0
    finally:
        eng.shutdown()


def test_page_gate_is_fifo():
    """The head request waits for its pages; a smaller one behind it
    never overtakes it."""
    eng = ContinuousEngine(TCFG, PARAMS, slots=3, chunk=2, max_len=40,
                           page_size=8, total_pages=5, device="cpu",
                           kv_layout="paged")
    try:
        first = eng.submit_async([1] * 8, 24)     # 4 pages
        big = eng.submit_async([2] * 8, 24)       # 4 pages: must wait
        small = eng.submit_async([3], 2)          # 1 page: fits, but queued
        for h in (first, big, small):
            assert h.done.wait(WAIT) and h.error is None
        assert first.finished <= big.admitted_at <= small.admitted_at
        assert eng.stats()["kv_pages_free"] == 5
    finally:
        eng.shutdown()


def test_eos_and_deadline(engine):
    ref = engine.submit([1, 2, 3], 10, timeout=WAIT)
    eos = ref[3]
    got = engine.submit([1, 2, 3], 10, eos_id=eos, timeout=WAIT)
    assert got == ref[:ref.index(eos) + 1]
    late = engine.submit_async([4, 5], 3, deadline=time.perf_counter() - 1)
    assert late.done.wait(WAIT) and late.error == DEADLINE_ERROR
    assert engine.stats()["expired_queued"] == 1


def test_drain_finishes_in_flight_and_rejects_new(engine):
    a = engine.submit_async([1, 2], 12)
    assert engine.drain(timeout=WAIT)
    assert a.done.is_set() and not a.error and len(a.tokens) == 12
    with pytest.raises(RuntimeError, match="draining"):
        engine.submit_async([5], 2)
    assert engine.healthy()[0]


def test_stats_and_warmup(engine):
    assert engine.warmup(buckets=[16], burst=2) == 1
    st = engine.stats()
    assert st["completed"] == 0 and st["device"] == "cpu"
    # the CPU runs the plain attention: no kernel launches to count
    assert st["paged_attention_launches"] == 0
    assert st["kv_pages_free"] == st["kv_pages_total"] == 20


# -------------------------------------------------------------------------
# Sampling
# -------------------------------------------------------------------------


def test_sampling_reproducible_and_noise_injection(engine, monkeypatch):
    a = engine.submit([1, 2, 3], 8, temperature=0.9, seed=7, timeout=WAIT)
    b = engine.submit([1, 2, 3], 8, temperature=0.9, seed=7, timeout=WAIT)
    assert a == b                           # same seed, same stream
    greedy = engine.submit([1, 2, 3], 8, timeout=WAIT)
    # with the noise injected as zeros, a sampled request is greedy
    from tpu_dra_torch.workloads import continuous
    monkeypatch.setattr(continuous, "gumbel_noise",
                        lambda n, g: torch.zeros(n))
    assert engine.submit([1, 2, 3], 8, temperature=0.9, seed=7,
                         timeout=WAIT) == greedy


def test_select_tokens_samples_the_softmax():
    """Gumbel-max over 20k rows reproduces softmax(logits / T): each
    marginal within 0.015 (over 4 standard errors at n = 20000)."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -3.0])
    T, n = 0.8, 20000
    gen = torch.Generator()
    gen.manual_seed(0)
    noise = gumbel_noise(n * len(logits), gen).reshape(n, len(logits))
    toks = select_tokens(logits.expand(n, -1), torch.full((n,), T), noise)
    freq = np.bincount(toks.numpy(), minlength=len(logits)) / n
    want = torch.softmax(logits / T, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.015)
    # top-k 2 keeps only the two best tokens
    toks = select_tokens(logits.expand(n, -1), torch.full((n,), T), noise,
                         top_k=2)
    assert set(toks.tolist()) == {0, 1}
    # temperature 0 rows are greedy whatever the noise
    assert select_tokens(logits[None], torch.zeros(1),
                         noise[:1]).item() == 0


# -------------------------------------------------------------------------
# Left for later slices
# -------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(kv_layout="slab", draft=(TCFG, PARAMS), chunk=1), "chunk >= 2"),
    (dict(draft=(TCFG, PARAMS), chunk=1), "chunk >= 2"),
    (dict(logit_bias={128: -1e9}), "logit_bias token ids")],
    ids=["slab", "draft", "logit_bias"])
def test_later_engine_features_raise(kw, match):
    """Drafts (both layouts) and logit bias are served since the
    speculative slice (tests/test_torch_spec.py); what the reference
    refuses of them, the port refuses."""
    with pytest.raises(ValueError, match=match):
        ContinuousEngine(TCFG, PARAMS, **dict(ENGINE_KW, **kw))


def test_later_request_features_raise(engine):
    with pytest.raises(ValueError, match="later slice"):
        engine.submit_async([1, 2], 3, prefix_id="p")
    with pytest.raises(ValueError, match="later slice"):
        engine.submit_async([1, 2], 3, stop=[[5]])
    with pytest.raises(ValueError, match="later slice"):
        engine.submit_handoff(object(), 3)
    with pytest.raises(ValueError, match="max_len"):
        engine.submit_async([1] * 30, 20)
