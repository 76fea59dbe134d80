"""Shared prefixes and stop sequences of the PyTorch port's continuous
engine (tpu_dra_torch/workloads/continuous.py) on the CPU, in both KV
layouts, plainly and speculatively: the reference's prefix and stop
tests (tests/test_continuous.py, tests/test_continuous_paged.py) run
against the port, with the JAX engine beside it on the same weights.

On the CPU a prefix join is held exactly to the port's own decode of
prefix + suffix (the reference's contract), and to the JAX engine's
tokens by the near-tie rule (``assert_greedy_agrees``, the reference's
logits from its slab decoder fed the reference's tokens).
"""

from __future__ import annotations

import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    assert_greedy_agrees,
    cfg_pair,
    jax_params,
    to_torch,
)

from tpu_dra.workloads import decode as jd
from tpu_dra.workloads.continuous import ContinuousEngine as JaxEngine
from tpu_dra_torch.resilience import failpoint
from tpu_dra_torch.workloads import decode as td
from tpu_dra_torch.workloads.continuous import (
    DEADLINE_ERROR,
    ContinuousEngine,
    _Request,
)

CFG_KW = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=128, max_seq=64, pos_emb="rope", tied_embeddings=True)
JCFG, TCFG = cfg_pair(**CFG_KW)
# the scaled tied embedding spreads logit gaps past bf16 noise, as
# tests/test_continuous_paged.py does
JPARAMS = jax_params(JCFG, seed=0, embed_scale=4.0)
PARAMS = to_torch(JPARAMS)
JDCFG, DCFG = cfg_pair(**dict(CFG_KW, d_model=32, n_heads=2, n_kv_heads=1,
                              n_layers=1, d_ff=64))
JDPARAMS = jax_params(JDCFG, seed=5)
DPARAMS = to_torch(JDPARAMS)
BASE = dict(slots=4, chunk=2, max_len=40, page_size=8)
LAYOUTS = ["slab", "paged"]
# 20 tokens: 2 full pages of 8 and a 4-token tail in each joiner's pages
PREFIX = list(range(11, 31))
SUFFIXES = [([1, 2], 5), ([3], 7), ([4, 5, 6], 4)]
WAIT = 120


def engine(layout="paged", params=PARAMS, **kw):
    return ContinuousEngine(TCFG, params, device="cpu",
                            **dict(BASE, kv_layout=layout, **kw))


def jax_engine(layout="paged", **kw):
    return JaxEngine(JCFG, JPARAMS, **dict(BASE, kv_layout=layout, **kw))


def port_decode(prompt, steps, cache_dtype="bf16"):
    return td.decode(TCFG, PARAMS, torch.tensor([prompt]), steps=steps,
                     max_len=40, cache_dtype=cache_dtype)[0].tolist()


def ref_logits(prompt, tokens, cache_dtype="bf16"):
    """The reference slab decoder's logits ``[steps, V]`` fed
    ``tokens`` (step i's logits follow tokens < i)."""
    cache = jd.init_kv_cache(JCFG, 1, 40, cache_dtype)
    cache, logits = jd.prefill(JCFG, JPARAMS, cache,
                               jnp.asarray([prompt], jnp.int32))
    out = [np.asarray(logits)[0]]
    for i, tok in enumerate(tokens[:-1]):
        logits, cache = jd._token_logits(JCFG, JPARAMS, cache,
                                         len(prompt) + i,
                                         jnp.asarray([tok], jnp.int32))
        out.append(np.asarray(logits)[0])
    return np.stack(out)


def serve_prefix(eng, prefix, suffixes, **kw):
    pid = eng.register_prefix(prefix)
    return pid, [eng.submit(s, st, prefix_id=pid, timeout=WAIT, **kw)
                 for s, st in suffixes]


def refs(eng, pages):
    with eng._pool_mu:
        return [eng.pool._refs.get(p, 0) for p in pages]


def trimmed(tokens, stops):
    """``tokens`` cut before the first completed stop sequence."""
    for j in range(1, len(tokens) + 1):
        for seq in stops:
            if j >= len(seq) and tokens[j - len(seq):j] == seq:
                return tokens[:j - len(seq)]
    return tokens


def wait_for(cond, timeout=WAIT):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


# -------------------------------------------------------------------------
# Prefix joins against the full prompt and the JAX engine
# -------------------------------------------------------------------------


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefix_join_equals_full_prompt_decode(layout, cache_dtype):
    """A registered prefix + suffix decodes exactly like the full prompt
    (tests/test_continuous.py :225, :266; the int8 engine registers the
    prefix KV quantized and joins take it raw), and follows the JAX
    engine's prefix joins; plain requests through the same engine stay
    right, and on pages the prefix's 2 pages stay resident."""
    eng = engine(layout, cache_dtype=cache_dtype)
    try:
        pid, got = serve_prefix(eng, PREFIX, SUFFIXES)
        plain = eng.submit([7, 3], 3, timeout=WAIT)
        st = eng.stats()
    finally:
        eng.shutdown()
    for (sfx, steps), toks in zip(SUFFIXES, got):
        assert toks == port_decode(PREFIX + sfx, steps, cache_dtype), sfx
    assert plain == port_decode([7, 3], 3, cache_dtype)
    if layout == "paged":
        assert st["kv_pages_free"] == st["kv_pages_total"] - 2
    jeng = jax_engine(layout, cache_dtype=cache_dtype)
    try:
        jpid, want = serve_prefix(jeng, PREFIX, SUFFIXES)
    finally:
        jeng.shutdown()
    assert jpid == pid                       # the same content address
    for (sfx, _), w, g in zip(SUFFIXES, want, got):
        assert_greedy_agrees(w, ref_logits(PREFIX + sfx, w, cache_dtype), g)


def test_prefix_registration_idempotent_and_lru():
    """tests/test_continuous.py :243: content-addressed ids (the JAX
    engine's own), LRU eviction at max_prefixes, and the reference's
    refusals."""
    eng = engine("slab", slots=2, max_prefixes=2)
    jeng = jax_engine("slab", slots=2, max_prefixes=2)
    try:
        a = eng.register_prefix([1, 2, 3])
        assert a == jeng.register_prefix([1, 2, 3])
        assert eng.register_prefix([1, 2, 3]) == a
        b = eng.register_prefix([4, 5])
        assert b == jeng.register_prefix([4, 5]) and a != b
        eng.register_prefix([1, 2, 3])                  # refresh a's LRU
        eng.register_prefix([6, 7, 8])                  # evicts b
        assert list(eng._prefixes) == [a, eng.register_prefix([6, 7, 8])]
        with pytest.raises(ValueError, match="evicted or never"):
            eng.submit([9], 2, prefix_id=b)
        assert len(eng.submit([9], 2, prefix_id=a, timeout=WAIT)) == 2
        for bad, match in (([], "non-empty"), ([1] * 40, "leave room"),
                           ([128], "token ids")):
            with pytest.raises(ValueError, match=match):
                eng.register_prefix(bad)
            with pytest.raises(ValueError, match=match):
                jeng.register_prefix(bad)
        # prefix + prompt + steps must fit max_len (3 + 20 + 20 > 40)
        with pytest.raises(ValueError, match="prefix 3 .* exceeds"):
            eng.submit([1] * 20, 20, prefix_id=a)
    finally:
        eng.shutdown()
        jeng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sampled_prefix_requests_reproducible(layout):
    """Sampled prefix joins draw from the request's seed: the same seed
    gives the same tokens across engines, another seed others."""
    outs = []
    for _ in range(2):
        eng = engine(layout, params=to_torch(jax_params(JCFG, seed=0)))
        try:
            pid = eng.register_prefix(PREFIX)
            outs.append([eng.submit([1, 2], 8, temperature=0.9, seed=s,
                                    prefix_id=pid, timeout=WAIT)
                         for s in (3, 4)])
        finally:
            eng.shutdown()
    assert outs[0] == outs[1]
    assert outs[0][0] != outs[0][1]
    assert all(len(t) == 8 and all(0 <= x < 128 for x in t)
               for t in outs[0])


# -------------------------------------------------------------------------
# Zero-copy pages
# -------------------------------------------------------------------------


def test_paged_prefix_join_matches_slab():
    """tests/test_continuous_paged.py :191: the layouts give the same
    tokens; the prefix's 2 full pages are written once and reused, and
    once the joiners retire only the registry's reference is left."""
    slab = engine("slab")
    try:
        _, want = serve_prefix(slab, PREFIX, SUFFIXES)
    finally:
        slab.shutdown()
    eng = engine("paged")
    try:
        pid = eng.register_prefix(PREFIX)
        pref = eng._prefixes[pid]
        assert pref.pages is not None and len(pref.pages) == 2
        assert not pref.pages_written
        got = [eng.submit(s, st, prefix_id=pid, timeout=WAIT)
               for s, st in SUFFIXES]
        assert eng._prefixes[pid].pages == pref.pages and pref.pages_written
        assert refs(eng, pref.pages) == [1, 1]
        st = eng.stats()
        assert st["kv_pages_free"] == st["kv_pages_total"] - 2
    finally:
        eng.shutdown()
    assert got == want


def test_paged_prefix_shares_pages_concurrently():
    """:215: two joiners in flight hold the same physical prefix pages
    (refcount 3: the registry and two slots), each with its own pages
    for the tail and the suffix."""
    eng = engine("paged", slots=2, total_pages=8)
    try:
        pid = eng.register_prefix(list(range(30, 46)))
        pages = list(eng._prefixes[pid].pages)
        a = eng.submit_async([1, 2], 12, prefix_id=pid)
        b = eng.submit_async([3, 4], 12, prefix_id=pid)
        assert wait_for(lambda: refs(eng, pages) == [3, 3]
                        or (a.done.is_set() and b.done.is_set()))
        saw_shared = refs(eng, pages) == [3, 3] or \
            eng.stats()["peak_active"] == 2
        assert a.done.wait(WAIT) and not a.error
        assert b.done.wait(WAIT) and not b.error
        assert saw_shared, "never saw both slots sharing the pages"
        assert len(a.tokens) == 12 and len(b.tokens) == 12
        assert refs(eng, pages) == [1, 1]
        st = eng.stats()
        assert st["kv_pages_peak_used"] == 2 + st["kv_pages_own_at_peak"]
    finally:
        eng.shutdown()


def test_paged_prefix_eviction_while_in_use():
    """:241: evicting a prefix mid-flight leaves its pages live under the
    joiner's references until it retires; then every reference is
    gone."""
    eng = engine("paged", slots=2, total_pages=10, max_prefixes=2)
    try:
        pid = eng.register_prefix(list(range(50, 66)))
        pages = list(eng._prefixes[pid].pages)
        h = eng.submit_async([1, 2], 16, prefix_id=pid)
        assert wait_for(lambda: h.tokens or h.done.is_set()) and h.tokens
        eng.register_prefix(list(range(70, 86)))
        eng.register_prefix(list(range(90, 106)))
        assert pid not in eng._prefixes
        assert h.done.wait(WAIT) and not h.error and len(h.tokens) == 16
        assert refs(eng, pages) == [0, 0]
        st = eng.stats()
        assert st["kv_pages_free"] == st["kv_pages_total"] - 4
    finally:
        eng.shutdown()


def test_paged_short_prefix_degrades_to_unshared():
    """:270: a prefix under one page has no page to share (pages None);
    joins carry it in their own pages and give the slab's tokens."""
    slab = engine("slab", slots=2)
    try:
        _, want = serve_prefix(slab, [33, 34, 35], [([1, 2], 6)])
    finally:
        slab.shutdown()
    eng = engine("paged", slots=2)
    try:
        pid, got = serve_prefix(eng, [33, 34, 35], [([1, 2], 6)])
        assert eng._prefixes[pid].pages is None
        st = eng.stats()
        assert st["kv_pages_free"] == st["kv_pages_total"]
    finally:
        eng.shutdown()
    assert got == want


def test_prefix_registered_on_an_exhausted_pool_degrades():
    """A prefix registered while the pool has no room for its full pages
    degrades to unshared pages too, and still decodes right."""
    eng = engine("paged", slots=1, total_pages=5)
    try:
        hog = eng.submit_async([1] * 8, 30)          # all 5 pages
        assert wait_for(lambda: hog.tokens or hog.done.is_set())
        pid = eng.register_prefix(PREFIX)
        assert eng._prefixes[pid].pages is None
        got = eng.submit([1, 2], 5, prefix_id=pid, timeout=WAIT)
        assert hog.done.wait(WAIT) and not hog.error
    finally:
        eng.shutdown()
    assert got == port_decode(PREFIX + [1, 2], 5)


def test_resident_prefix_pages_fail_oversized_request_fast():
    """:287: a request that fits the pool but never the pages resident
    prefixes leave must fail at admission, not stall the FIFO."""
    eng = engine("paged", slots=2, total_pages=4)
    try:
        eng.register_prefix(list(range(50, 66)))     # 2 resident pages
        h = eng.submit_async([1] * 8, 14)            # 3 own pages
        assert h.done.wait(WAIT)
        assert h.error and "resident prefixes" in h.error
        assert len(eng.submit([1, 2], 3, timeout=WAIT)) == 3
    finally:
        eng.shutdown()


def test_prefix_join_head_over_ceiling_fails_not_stalls():
    """:306: a joining head that needs more own pages than total less
    resident can ever free fails at the gate (its shared pages do not
    raise the ceiling), its gate references come back, and the queue
    behind it serves."""
    eng = engine("paged", slots=2, total_pages=4)
    try:
        pid = eng.register_prefix(list(range(50, 66)))
        pages = list(eng._prefixes[pid].pages)
        # 16 + 8 + 16 = 40 tokens: 5 pages, 2 shared, 3 own > 4 - 2
        h = eng.submit_async([1] * 8, 16, prefix_id=pid)
        assert h.done.wait(WAIT)
        assert h.error and "resident prefixes" in h.error
        assert refs(eng, pages) == [1, 1]
        assert len(eng.submit([1, 2], 3, timeout=WAIT)) == 3
    finally:
        eng.shutdown()


def test_paged_prefix_evict_reregister_race_fails_request():
    """:324: an evict and re-register of the same id between the gate
    and the join fails the request (the slot's table holds the old
    ids), and the slot's references roll back."""
    prefix = list(range(50, 66))
    eng = engine("paged", slots=2, total_pages=10)
    try:
        pid = eng.register_prefix(prefix)
        old = eng._prefixes[pid]
        shared, need, gate_pref = eng._paged_requirements(
            2, 4, pid, take_refs=True)
        assert gate_pref is old and shared == list(old.pages)
        with eng._pool_mu:
            own = eng.pool.alloc(need)
        slot = 0
        eng._page_ids[slot] = own
        eng._shared_ids[slot] = list(shared)
        eng._table[slot] = torch.from_numpy(
            eng.pool.table_row(shared + own, eng._mp))
        req = _Request(prompt=[1, 2], steps=4, eos_id=None,
                       temperature=0.0, seed=0, prefix_id=pid,
                       gate_prefix=gate_pref)
        eng._requests[slot] = req
        with eng._cv:
            evicted = eng._prefixes.pop(pid)
        eng._evict_prefix_pages(evicted)
        assert eng.register_prefix(prefix) == pid
        assert eng._prefixes[pid] is not old
        eng._admit_prefix(slot, req)
        assert req.done.is_set() and "evicted" in req.error
        assert eng._requests[slot] is None
        assert bool((eng._table[slot] == -1).all())
        st = eng.stats()
        assert st["kv_pages_free"] == st["kv_pages_total"] - 2
    finally:
        eng.shutdown()


@pytest.mark.parametrize("how", ["cancel", "deadline"])
def test_aborted_joiner_returns_every_reference(how):
    """A joiner cancelled or past its deadline mid-flight returns its
    own pages and its references on the shared ones."""
    eng = engine("paged", slots=2)
    # 100 ms a pass: the 9 passes outlast the 0.3 s deadline
    failpoint.activate("serve.engine.slow_decode=sleep(100)")
    try:
        pid = eng.register_prefix(PREFIX)
        pages = list(eng._prefixes[pid].pages)
        h = eng.submit_async([1, 2], 18, prefix_id=pid,
                             deadline=(time.perf_counter() + 0.3
                                       if how == "deadline" else None))
        assert wait_for(lambda: h.tokens or h.done.is_set())
        if how == "cancel":
            eng.cancel(h)
        assert h.done.wait(WAIT)
        assert h.error == ("cancelled" if how == "cancel"
                           else DEADLINE_ERROR), h.error
        assert wait_for(lambda: eng.stats()["active"] == 0)
        assert refs(eng, pages) == [1, 1]
        st = eng.stats()
        assert st["kv_pages_free"] == st["kv_pages_total"] - 2
        assert st["badput_slot_s"][
            "cancelled" if how == "cancel" else "deadline_expired"] > 0
    finally:
        failpoint.reset()
        eng.shutdown()


def test_register_and_join_under_thread_churn():
    """Registrations on callers' threads (evicting each other at
    max_prefixes 2) race joins and plain requests on the batcher thread,
    with a short switch interval: every request completes or fails with
    the eviction error, and the pool ends holding exactly the
    registry's pages, each at one reference."""
    eng = engine("paged", slots=4, total_pages=24, max_prefixes=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors, handles = [], []
    mu = threading.Lock()

    def worker(w):
        try:
            for i in range(4):
                pid = eng.register_prefix([w * 20 + i + 1] * (8 + 4 * w))
                try:
                    h = eng.submit_async([w + 1, i + 1], 3, prefix_id=pid)
                except ValueError as exc:     # evicted since registering
                    assert "unknown prefix_id" in str(exc)
                    continue
                with mu:
                    handles.append(h)
                    handles.append(eng.submit_async([w + 2], 2))
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for h in handles:
            assert h.done.wait(WAIT)
            assert h.error is None or "evicted before admission" in h.error
        assert wait_for(lambda: eng.stats()["active"] == 0)
        with eng._cv:
            resident = [p for pref in eng._prefixes.values()
                        for p in (pref.pages or ())]
        assert refs(eng, resident) == [1] * len(resident)
        with eng._pool_mu:
            assert set(eng.pool._refs) == set(resident)
        st = eng.stats()
        assert st["kv_pages_free"] == st["kv_pages_total"] - len(resident)
    finally:
        sys.setswitchinterval(old)
        eng.shutdown()


def test_unknown_prefix_on_pages():
    """:43: an unknown id raises the reference's error on pages too."""
    eng = engine("paged")
    try:
        with pytest.raises(ValueError, match="unknown prefix_id"):
            eng.submit([1], 2, prefix_id="nope")
    finally:
        eng.shutdown()


# -------------------------------------------------------------------------
# Speculative joins
# -------------------------------------------------------------------------


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_speculative_prefix_join_matches_plain(layout, cache_dtype):
    """tests/test_continuous.py :520, tests/test_continuous_paged.py
    :478: prefix joins through the speculative engine give the plain
    engine's tokens; the registry holds the draft's prefix KV, and on
    pages the shared pages are written once for both pools."""
    sfx = [([1, 2], 6), ([3], 8)]
    plain = engine(layout, slots=2, cache_dtype=cache_dtype)
    try:
        _, want = serve_prefix(plain, list(range(60, 76)), sfx)
    finally:
        plain.shutdown()
    spec = engine(layout, slots=2, cache_dtype=cache_dtype,
                  draft=(DCFG, DPARAMS))
    try:
        pid, got = serve_prefix(spec, list(range(60, 76)), sfx)
        pref = spec._prefixes[pid]
        assert pref.dkv is not None
        st = spec.stats()
        if layout == "paged":
            assert pref.pages_written
            assert st["kv_pages_free"] == st["kv_pages_total"] - 2
    finally:
        spec.shutdown()
    assert got == want


@pytest.mark.parametrize("layout", LAYOUTS)
def test_speculative_prefix_join_draft_sees_context(layout):
    """:544 and the paged detector of :478: draft == target through a
    join accepts every proposal; a draft cache without the prefix would
    propose against garbage and reject."""
    spec = engine(layout, slots=2, chunk=4, total_pages=12
                  if layout == "paged" else None, draft=(TCFG, PARAMS))
    try:
        pid = spec.register_prefix(list(range(40, 56)))
        out = spec.submit([1, 2], 12, prefix_id=pid, timeout=WAIT)
        st = spec.stats()
    finally:
        spec.shutdown()
    assert len(out) == 12
    assert st["spec_accept_rate"] == 1.0, st
    assert st["spec_tokens_per_pass"] >= 3.0, st


def test_speculative_prefix_follows_the_jax_engine():
    """The port's paged speculative prefix joins follow the JAX paged
    speculative engine's greedy tokens, up to a reference near-tie."""
    sfx = [([1, 2], 6), ([3], 8)]
    jeng = jax_engine("paged", slots=2, total_pages=10,
                      draft=(JDCFG, JDPARAMS))
    try:
        _, want = serve_prefix(jeng, list(range(60, 76)), sfx)
    finally:
        jeng.shutdown()
    spec = engine("paged", slots=2, total_pages=10, draft=(DCFG, DPARAMS))
    try:
        _, got = serve_prefix(spec, list(range(60, 76)), sfx)
    finally:
        spec.shutdown()
    for (s, _), w, g in zip(sfx, want, got):
        assert_greedy_agrees(w, ref_logits(list(range(60, 76)) + s, w), g)


def test_paged_spec_mixed_churn():
    """:531: greedy, sampled and prefix requests racing on a paged
    speculative engine: every request completes at its length, greedy
    plain ones equal the plain engine's, the pool heals to the
    registry's pages."""
    prefix = list(range(80, 96))
    reqs = [([3, 5, 7], 6, 0.0, None), ([2, 4], 8, 0.8, None),
            ([1, 2], 6, 0.0, "p"), ([9, 9, 9], 5, 0.7, "p"),
            ([4], 7, 0.0, None), ([6, 5], 6, 0.0, "p")]
    plain = engine("paged")
    try:
        want = {i: plain.submit(p, s, timeout=WAIT)
                for i, (p, s, t, x) in enumerate(reqs) if not t and not x}
    finally:
        plain.shutdown()
    eng = engine("paged", total_pages=16, draft=(DCFG, DPARAMS))
    try:
        pid = eng.register_prefix(prefix)
        handles = [eng.submit_async(p, s, temperature=t, seed=i,
                                    prefix_id=pid if x else None)
                   for i, (p, s, t, x) in enumerate(reqs)]
        for h, (_, s, _, _) in zip(handles, reqs):
            assert h.done.wait(WAIT) and not h.error, h.error
            assert len(h.tokens) == s
        st = eng.stats()
    finally:
        eng.shutdown()
    for i, toks in want.items():
        assert handles[i].tokens == toks, i
    assert st["kv_pages_free"] == st["kv_pages_total"] - 2


# -------------------------------------------------------------------------
# Stop sequences
# -------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_stop_sequences(layout):
    """tests/test_continuous.py :588: a stop retires the request and is
    trimmed (a match across a chunk boundary too), the first completed
    of several wins, an unmatched stop runs to the steps cap; the
    refusals are the JAX engine's."""
    eng = engine(layout, slots=2)
    jeng = jax_engine(layout, slots=2)
    try:
        ref = eng.submit([3, 5, 7], 10, timeout=WAIT)
        jref = jeng.submit([3, 5, 7], 10, timeout=WAIT)
        assert_greedy_agrees(jref, ref_logits([3, 5, 7], jref), ref)
        stop_seq = ref[3:5]              # starts at an odd index
        got = eng.submit([3, 5, 7], 10, stop=[stop_seq], timeout=WAIT)
        assert got == trimmed(ref, [stop_seq]) and len(got) <= 3, (got, ref)
        # several: the first completed match wins (here the first token)
        got2 = eng.submit([3, 5, 7], 10, stop=[stop_seq, [ref[0]]],
                          timeout=WAIT)
        assert got2 == []
        unused = [t for t in range(128) if t not in ref][:2]
        assert eng.submit([3, 5, 7], 10, stop=[unused],
                          timeout=WAIT) == ref
        if ref == jref:
            assert jeng.submit([3, 5, 7], 10, stop=[stop_seq],
                               timeout=WAIT) == got
        for bad, match in (([], "stop must be"), ([[1]] * 9, "stop must be"),
                           ([[1] * 17], "each stop"),
                           ([[128 + 5]], "stop token ids")):
            for e in (eng, jeng):
                with pytest.raises(ValueError, match=match):
                    e.submit([1], 2, stop=bad)
        st = eng.stats()
        if layout == "paged":
            assert st["kv_pages_free"] == st["kv_pages_total"]
    finally:
        eng.shutdown()
        jeng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_stop_sequences_speculative(layout):
    """:623: a speculative pass commits several tokens at once; the stop
    is matched after each, so the trim and the retire point are the
    plain engine's."""
    plain = engine(layout, slots=2)
    try:
        ref = plain.submit([3, 5, 7], 10, timeout=WAIT)
        want = plain.submit([3, 5, 7], 10, stop=[ref[3:5]], timeout=WAIT)
    finally:
        plain.shutdown()
    spec = engine(layout, slots=2, chunk=4, draft=(TCFG, PARAMS))
    try:
        got = spec.submit([3, 5, 7], 10, stop=[ref[3:5]], timeout=WAIT)
        st = spec.stats()
    finally:
        spec.shutdown()
    assert got == want
    assert st["completed"] == 1
    if layout == "paged":
        assert st["kv_pages_free"] == st["kv_pages_total"]


def test_stop_with_a_prefix():
    """A stop on a prefix join trims the join's own stream."""
    eng = engine("paged", slots=2)
    try:
        pid = eng.register_prefix(PREFIX)
        ref = eng.submit([1, 2], 8, prefix_id=pid, timeout=WAIT)
        got = eng.submit([1, 2], 8, prefix_id=pid, stop=[ref[2:4]],
                         timeout=WAIT)
    finally:
        eng.shutdown()
    assert got == trimmed(ref, [ref[2:4]])
