"""Slab KV decoding of the PyTorch port (tpu_dra_torch/workloads/
decode.py) against the JAX package on the CPU: the cache writes (drops
past the end, never wraps a negative position), one decoder block over
bf16 and int8 caches and a window, the three prefills, greedy and ragged
decoding over bf16, int8 and int4 weights, sampling, eos and the
repetition penalty, and the guards."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    assert_greedy_agrees,
    cfg_pair,
    f32,
    jax_params,
    logit_tol,
    to_torch,
)

from tpu_dra.workloads import decode as jd
from tpu_dra.workloads import quant as jq
from tpu_dra_torch.workloads import decode as td

CFG_KW = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=64, max_seq=32, pos_emb="rope")
JCFG, TCFG = cfg_pair(**CFG_KW)
JPARAMS = jax_params(JCFG, seed=0)
FORMS = {"bf16": jq.cast_params_bf16, "int8": jq.quantize_params_int8,
         "int4": lambda p: jq.quantize_params_int4(p, group=16)}
# the cache write's rounding: one bf16 ulp of the values written
CACHE_TOL = 2 ** -7


def serving(form, jparams=JPARAMS):
    """(reference serving tree, the port's copy of it)."""
    jp = FORMS[form](jparams)
    return jp, to_torch(jp)


def prompts(B, S, seed=1, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def jax_forced_logits(jcfg, jp, prompt, forced, *, max_len, cache_dtype,
                      lengths=None, window=None):
    """Reference logits ``[steps, B, V]`` of decode's steps when fed
    ``forced`` ``[B, steps]``: ``logits[i]`` chose token i."""
    B, S = prompt.shape
    cache = jd.init_kv_cache(jcfg, B, max_len, cache_dtype)
    if lengths is None:
        cache, logits = jd.prefill(jcfg, jp, cache, jnp.asarray(prompt),
                                   window=window)
    else:
        cache, logits = jd.prefill_ragged(jcfg, jp, cache,
                                          jnp.asarray(prompt),
                                          jnp.asarray(lengths))
    step = jax.jit(partial(jd._token_logits, jcfg, window=window))
    outs = [np.asarray(logits)]
    for i in range(forced.shape[1] - 1):
        pos = S + i if lengths is None else jnp.asarray(lengths) + i
        logits, cache = step(jp, cache, pos, jnp.asarray(forced[:, i]))
        outs.append(np.asarray(logits))
    return np.stack(outs)


def values(cache, name):
    """A cache's k or v values in fp32, int8 entries times their scales."""
    v = f32(cache[name])
    return v * f32(cache[f"{name}_s"]) if f"{name}_s" in cache else v


def assert_rows_agree(want, want_logits, got):
    agreed = [assert_greedy_agrees(want[b], want_logits[:, b], got[b])
              for b in range(want.shape[0])]
    assert sum(agreed) >= want.size // 2        # the check has teeth


# -------------------------------------------------------------------------
# The cache
# -------------------------------------------------------------------------


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_init_kv_cache_matches_reference(cache_dtype):
    want = jd.init_kv_cache(JCFG, 3, 20, cache_dtype)
    got = td.init_kv_cache(TCFG, 3, 20, cache_dtype, device="cpu")
    assert sorted(got) == sorted(want)
    for name, buf in got.items():
        assert tuple(buf.shape) == want[name].shape
        assert str(buf.dtype).split(".")[-1] == want[name].dtype.name
        assert not bool(buf.any())
    with pytest.raises(ValueError, match="bf16 or int8"):
        td.init_kv_cache(TCFG, 1, 4, "fp8", device="cpu")


WRITES = {"m1-one-past-end": ([3, 9, 10, 12], 1),
          "m3-straddles-end": ([0, 8, 9, 11], 3),
          "m3-in-range": ([0, 2, 4, 7], 3)}


@pytest.mark.parametrize("case", WRITES.values(), ids=WRITES.keys())
def test_write_kv_drops_past_the_end_as_the_reference(case):
    pos, m = case
    B, S = len(pos), 10
    r = np.random.default_rng(2)
    cache = r.standard_normal((B, 2, S, 4)).astype(np.float32)
    new = r.standard_normal((B, 2, m, 4)).astype(np.float32)
    want = np.asarray(jd._write_kv(jnp.asarray(cache), jnp.asarray(new),
                                   jnp.asarray(pos, jnp.int32)))
    got = td._write_kv(torch.from_numpy(cache.copy()), torch.from_numpy(new),
                       torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [1, 3])
def test_write_kv_never_wraps_a_negative_position(m):
    """A negative position writes nothing (torch indexing, and the
    reference's scatter, would wrap it to the end of the row); the chunk's
    in-range entries still land."""
    B, S = 3, 8
    cache = torch.zeros((B, 1, S, 2))
    new = torch.arange(1, B * m * 2 + 1, dtype=torch.float32).reshape(
        B, 1, m, 2)
    pos = torch.tensor([-1, -m - 1, 5], dtype=torch.int32)
    td._write_kv(cache, new, pos)
    want = torch.zeros_like(cache)
    for b in range(B):
        for j in range(m):
            p = int(pos[b]) + j
            if 0 <= p < S:
                want[b, :, p] = new[b, :, j]
    assert torch.equal(cache, want)
    assert not bool(cache[:2, :, -1].any())     # nothing wrapped


# -------------------------------------------------------------------------
# One block, and the prefills
# -------------------------------------------------------------------------


def layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


BLOCKS = {"bf16": ("bf16", None, [3, 7, 0]),
          "int8-cache": ("int8", None, [3, 7, 0]),
          "window": ("bf16", 4, [9, 2, 5]),
          "int8-window": ("int8", 4, [9, 2, 5])}


@pytest.mark.parametrize("case", BLOCKS.values(), ids=BLOCKS.keys())
def test_decode_block_matches_reference(case):
    """One decode step of one block at ragged positions over a cache
    already holding values: the block's output and every cache entry
    against the reference's."""
    cache_dtype, window, pos = case
    S = window or 12
    jp, tp = serving("int8")
    B = len(pos)
    r = np.random.default_rng(3)
    x = jnp.asarray(r.standard_normal((B, 1, 32)), jnp.bfloat16)
    kv = jnp.asarray(r.standard_normal((2, B, 2, S, 8)), jnp.bfloat16)
    jc = {"k": kv[0], "v": kv[1]}
    if cache_dtype == "int8":
        (kq, ks), (vq, vs) = jq.quantize_kv(kv[0]), jq.quantize_kv(kv[1])
        jc = {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
    jpos = jnp.asarray(pos, jnp.int32)
    scales = ({"k_s_cache": jc["k_s"], "v_s_cache": jc["v_s"]}
              if cache_dtype == "int8" else {})
    want = jd._decode_block(JCFG, x, layer(jp["blocks"], 1), jc["k"],
                            jc["v"], jpos, window=window, **scales)
    tc = to_torch(jc)
    tscales = ({"k_s_cache": tc["k_s"], "v_s_cache": tc["v_s"]}
               if cache_dtype == "int8" else {})
    got = td._decode_block(TCFG, to_torch({"x": x})["x"],
                           td.layer_params(tp["blocks"], 1), tc["k"],
                           tc["v"], torch.tensor(pos, dtype=torch.int32),
                           window=window, **tscales)
    np.testing.assert_allclose(f32(got), np.asarray(want[0], np.float32),
                               rtol=2 ** -6, atol=2 ** -6)
    names = ["k", "v"] + (["k_s", "v_s"] if cache_dtype == "int8" else [])
    for name, w in zip(names, want[1:]):
        w = np.asarray(w, np.float32)
        g = f32(tc[name])
        if name in ("k", "v") and cache_dtype == "int8":
            # int8 codes: a one-ulp input difference may move a code by 1
            assert np.abs(g - w).max() <= 1, name
        else:
            np.testing.assert_allclose(g, w, rtol=CACHE_TOL, atol=CACHE_TOL,
                                       err_msg=name)


def test_decode_block_refuses_a_window_over_a_chunk():
    _, tp = serving("bf16")
    c = td.init_kv_cache(TCFG, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="decode-step"):
        td._decode_block(TCFG, torch.zeros(1, 2, 32, dtype=torch.bfloat16),
                         td.layer_params(tp["blocks"], 0), c["k"][0],
                         c["v"][0], torch.tensor([0]), window=4)


PREFILLS = ["prefill", "prefill-window", "chunked", "chunked-tail",
            "ragged"]


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kind", PREFILLS)
def test_prefills_match_reference(kind, cache_dtype):
    """Last-token logits within the bf16 logit tolerance; the cache's
    bf16 entries within one ulp (int8 codes within one step)."""
    jp, tp = serving("int8")
    B, S, cap = 2, 7, 16
    p = prompts(B, S, seed=4)
    lengths = np.asarray([7, 4], np.int32)
    window = 4 if kind == "prefill-window" else None
    jc = jd.init_kv_cache(JCFG, B, window or cap, cache_dtype)
    tc = td.init_kv_cache(TCFG, B, window or cap, cache_dtype, device="cpu")
    tp_ = torch.from_numpy(p).long()
    if kind.startswith("prefill"):
        jc, want = jd.prefill(JCFG, jp, jc, jnp.asarray(p), window=window)
        tc, got = td.prefill(TCFG, tp, tc, tp_, window=window)
    elif kind.startswith("chunked"):
        chunk = 3 if kind == "chunked-tail" else 7
        jc, want = jd.prefill_chunked(JCFG, jp, jc, jnp.asarray(p), chunk)
        tc, got = td.prefill_chunked(TCFG, tp, tc, tp_, chunk)
    else:
        jc, want = jd.prefill_ragged(JCFG, jp, jc, jnp.asarray(p),
                                     jnp.asarray(lengths))
        tc, got = td.prefill_ragged(TCFG, tp, tc, tp_,
                                    torch.from_numpy(lengths))
    want = np.asarray(want)
    assert (np.abs(f32(got) - want)
            < logit_tol(want.max(-1, keepdims=True))).all()
    for name in ("k", "v"):
        g, w = values(tc, name), values(jc, name)
        # layer 0 within one rounding of what is written (an int8 code may
        # move by one step), the next within the block's bf16 tolerance
        np.testing.assert_allclose(
            g[0], w[0], rtol=CACHE_TOL,
            atol=CACHE_TOL + (np.abs(w[0]).max() / 127 if cache_dtype == "int8"
                              else 0), err_msg=name)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2 ** -5 * np.abs(w).max(),
                                   err_msg=name)


def test_chunked_prefill_refuses_a_prompt_past_the_cache():
    _, tp = serving("bf16")
    c = td.init_kv_cache(TCFG, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        td.prefill_chunked(TCFG, tp, c, torch.zeros(1, 5, dtype=torch.long))
    with pytest.raises(ValueError, match="chunk"):
        td.prefill_chunked(TCFG, tp, c, torch.zeros(1, 2, dtype=torch.long),
                           chunk=0)


def test_flash_prefill_matches_dense():
    """``attn_impl="flash"`` (the flash kernels on the card, their plain
    version here) fills the same cache as dense attention."""
    _, tp = serving("bf16")
    p = torch.from_numpy(prompts(2, 9, seed=5)).long()
    out = {}
    for impl in ("dense", "flash"):
        c = td.init_kv_cache(TCFG, 2, 12, device="cpu")
        out[impl] = td.prefill(TCFG, tp, c, p, attn_impl=impl)
    np.testing.assert_allclose(f32(out["flash"][1]), f32(out["dense"][1]),
                               atol=logit_tol(1.0) * 2, rtol=2 ** -6)
    # the first layer's k/v do not depend on attention
    assert torch.equal(out["flash"][0]["k"][0], out["dense"][0]["k"][0])


# -------------------------------------------------------------------------
# Greedy and ragged decoding
# -------------------------------------------------------------------------

GREEDY = {f"{w}-{c}": (w, c) for w in FORMS for c in ("bf16", "int8")}


@pytest.mark.parametrize("case", GREEDY.values(), ids=GREEDY.keys())
def test_greedy_decode_agrees_with_reference(case):
    form, cache_dtype = case
    jp, tp = serving(form)
    p, steps, max_len = prompts(3, 6, seed=6), 10, 20
    want = np.asarray(jd.greedy_decode(JCFG, jp, jnp.asarray(p), steps=steps,
                                       max_len=max_len,
                                       cache_dtype=cache_dtype))
    got = td.greedy_decode(TCFG, tp, torch.from_numpy(p).long(), steps=steps,
                           max_len=max_len, cache_dtype=cache_dtype)
    assert got.dtype == torch.int32 and got.shape == (3, steps)
    lg = jax_forced_logits(JCFG, jp, p, want, max_len=max_len,
                           cache_dtype=cache_dtype)
    assert_rows_agree(want, lg, got.numpy())


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_windowed_decode_agrees_with_reference(form, cache_dtype):
    """A ring of 5 slots over a 6-token prompt and 12 steps: the ring
    wraps several times."""
    jp, tp = serving(form)
    p, steps, window = prompts(2, 6, seed=7), 12, 5
    want = np.asarray(jd.greedy_decode(JCFG, jp, jnp.asarray(p), steps=steps,
                                       cache_dtype=cache_dtype,
                                       window=window))
    got = td.greedy_decode(TCFG, tp, torch.from_numpy(p).long(), steps=steps,
                           cache_dtype=cache_dtype, window=window)
    lg = jax_forced_logits(JCFG, jp, p, want, max_len=window,
                           cache_dtype=cache_dtype, window=window)
    assert_rows_agree(want, lg, got.numpy())


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_ragged_decode_agrees_with_reference(form, cache_dtype):
    jp, tp = serving(form)
    p, steps, max_len = prompts(3, 7, seed=8), 8, 16
    lengths = np.asarray([7, 2, 5], np.int32)
    want = np.asarray(jd.decode_ragged(JCFG, jp, jnp.asarray(p),
                                       jnp.asarray(lengths), steps=steps,
                                       max_len=max_len,
                                       cache_dtype=cache_dtype))
    got = td.decode_ragged(TCFG, tp, torch.from_numpy(p).long(),
                           torch.from_numpy(lengths), steps=steps,
                           max_len=max_len, cache_dtype=cache_dtype)
    lg = jax_forced_logits(JCFG, jp, p, want, max_len=max_len,
                           cache_dtype=cache_dtype, lengths=lengths)
    assert_rows_agree(want, lg, got.numpy())
    # each ragged row equals its own unpadded decode
    for b, n in enumerate(lengths):
        alone = td.greedy_decode(TCFG, tp, torch.from_numpy(p[b:b + 1, :n])
                                 .long(), steps=steps, max_len=max_len,
                                 cache_dtype=cache_dtype)
        assert alone[0].tolist() == got[b].tolist()


def test_learned_positions_decode_agrees_with_reference():
    jcfg, tcfg = cfg_pair(**dict(CFG_KW, pos_emb="learned", n_kv_heads=None))
    jp = jq.quantize_params_int8(jax_params(jcfg, seed=9))
    tp = to_torch(jp)
    p, steps = prompts(2, 5, seed=9), 9
    want = np.asarray(jd.greedy_decode(jcfg, jp, jnp.asarray(p), steps=steps))
    got = td.greedy_decode(tcfg, tp, torch.from_numpy(p).long(), steps=steps)
    lg = jax_forced_logits(jcfg, jp, p, want, max_len=jcfg.max_seq,
                           cache_dtype="bf16")
    assert_rows_agree(want, lg, got.numpy())


def test_repetition_penalty_and_eos_agree_with_reference():
    jp, tp = serving("bf16")
    p, steps = prompts(2, 6, seed=10), 12
    kw = dict(steps=steps, max_len=20, repetition_penalty=1.8)
    want = np.asarray(jd.decode(JCFG, jp, jnp.asarray(p), **kw))
    got = td.decode(TCFG, tp, torch.from_numpy(p).long(), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    eos = int(want[0, 3])
    want = np.asarray(jd.decode(JCFG, jp, jnp.asarray(p), eos_id=eos, **kw))
    got = td.decode(TCFG, tp, torch.from_numpy(p).long(), eos_id=eos,
                    **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_eos_freezes_a_sequence():
    _, tp = serving("int8")
    p = torch.from_numpy(prompts(2, 6, seed=11)).long()
    ref = td.greedy_decode(TCFG, tp, p, steps=12, max_len=20)
    eos = int(ref[0, 4])
    got = td.decode(TCFG, tp, p, steps=12, max_len=20, eos_id=eos)
    for row, want in zip(got.tolist(), ref.tolist()):
        if eos in want:
            k = want.index(eos)
            assert row[:k + 1] == want[:k + 1]
            assert row[k:] == [eos] * (12 - k)
        else:
            assert row == want


def test_ragged_repetition_penalty_ignores_pads():
    """Pad tokens of a ragged prompt are not 'seen': a row decodes as it
    does alone."""
    _, tp = serving("bf16")
    p = prompts(2, 6, seed=12)
    lengths = torch.tensor([6, 3], dtype=torch.int32)
    p[1, 3:] = 17                                  # pads that a bug would see
    got = td.decode_ragged(TCFG, tp, torch.from_numpy(p).long(), lengths,
                           steps=8, max_len=16, repetition_penalty=3.0)
    alone = td.decode(TCFG, tp, torch.from_numpy(p[1:, :3]).long(), steps=8,
                      max_len=16, repetition_penalty=3.0)
    assert got[1].tolist() == alone[0].tolist()


# -------------------------------------------------------------------------
# Sampling
# -------------------------------------------------------------------------


def test_sampling_is_reproducible_and_greedy_under_zero_noise(monkeypatch):
    _, tp = serving("int8")
    p = torch.from_numpy(prompts(2, 5, seed=13)).long()
    dec = td.make_decoder(TCFG, steps=8, max_len=16, temperature=0.8,
                          top_k=5, top_p=0.9, device="cpu")

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return dec(tp, p, g)

    a, b, c = draw(3), draw(3), draw(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < TCFG.vocab
    greedy = td.make_decoder(TCFG, steps=8, max_len=16, device="cpu")(tp, p)
    monkeypatch.setattr(td, "gumbel_noise", lambda n, g: torch.zeros(n))
    assert torch.equal(draw(3), greedy)


def test_select_token_samples_the_filtered_softmax():
    """Gumbel-max over 20k rows reproduces softmax(logits / T), each
    marginal within 0.015 (over 4 standard errors at n = 20000); top-k
    keeps its set, top-p its nucleus, temperature 0 is argmax."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -3.0])
    n, T = 20000, 0.8
    g = torch.Generator()
    g.manual_seed(0)
    toks = td._select_token(logits.expand(n, -1), g, T, 0)
    freq = np.bincount(toks.numpy(), minlength=6) / n
    np.testing.assert_allclose(freq, torch.softmax(logits / T, -1).numpy(),
                               atol=0.015)
    assert set(td._select_token(logits.expand(n, -1), g, T, 2).tolist()) \
        == {0, 1}
    probs = torch.softmax(logits / T, -1)
    assert float(probs[0]) < 0.7 < float(probs[:2].sum())
    assert set(td._select_token(logits.expand(n, -1), g, T, 0, 0.7)
               .tolist()) == {0, 1}
    assert td._select_token(logits[None], g, 0.0, 0).item() == 0


# -------------------------------------------------------------------------
# Guards and the later slice
# -------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(window=0), "window must be"),
    (dict(window=4, lengths=torch.tensor([3, 3])), "ragged"),
    (dict(window=4, max_len=8), "fixes the cache"),
    (dict(max_len=6), "exceeds max_len"),
    (dict(eos_id=64), "eos_id"),
    (dict(repetition_penalty=0.0), "repetition_penalty"),
    (dict(lengths=torch.tensor([0, 3])), "lengths must lie"),
    (dict(cache_dtype="fp8"), "cache_dtype"),
], ids=["window0", "window-ragged", "window-max_len", "max_len", "eos",
        "penalty", "lengths", "cache_dtype"])
def test_decode_guards(kw, match):
    _, tp = serving("bf16")
    with pytest.raises(ValueError, match=match):
        td.decode(TCFG, tp, torch.zeros(2, 3, dtype=torch.long), steps=4,
                  **kw)


def test_learned_positions_refuse_a_window_and_positions_past_the_table():
    jcfg, tcfg = cfg_pair(**dict(CFG_KW, pos_emb="learned"))
    tp = to_torch(jq.cast_params_bf16(jax_params(jcfg)))
    prompt = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="needs pos_emb='rope'"):
        td.decode(tcfg, tp, prompt, steps=4, window=8)
    with pytest.raises(ValueError, match="learned-position table"):
        td.decode(tcfg, tp, prompt, steps=30, max_len=64)


@pytest.mark.parametrize("name", ["speculative", "beam"])
def test_speculative_and_beam_decode_name_their_later_slice(name):
    """Both are ported now (tests/test_torch_spec.py,
    tests/test_torch_beam.py), and each refuses what the reference
    refuses before any work: speculative_decode fewer than 2 tokens a
    pass, beam_decode a beam count outside [1, vocab]."""
    prompt = torch.zeros(1, 2, dtype=torch.long)
    if name == "beam":
        with pytest.raises(ValueError, match="beams must be in"):
            td.beam_decode(TCFG, {}, prompt, steps=2, beams=0)
    else:
        _, tp = serving("bf16")
        with pytest.raises(ValueError, match="k must be >= 2"):
            td.speculative_decode(TCFG, tp, TCFG, tp, prompt, steps=2, k=1)


def test_make_decoder_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.make_decoder(TCFG, steps=2)
