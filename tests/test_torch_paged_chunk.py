"""The chunked paths of the PyTorch port's paged KV cache
(tpu_dra_torch/workloads/paged_kv.py: ``append_chunk``,
``paged_attention_chunk_ref``, ``paged_chunk_logits``,
``paged_chunked_prefill``, ``make_paged_decoder``) against the JAX
reference (tpu_dra/workloads/paged_kv.py), on the same numpy inputs.
"""

from __future__ import annotations

import jax.numpy as jnp
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

from tpu_dra.workloads import paged_kv as jpk
from tpu_dra.workloads.quant import quantize_kv as jquantize_kv
from tpu_dra_torch.workloads import paged_kv as tpk

# same rounding points on both sides (bf16-rounded scores taken to fp32,
# int8 scales outside the contractions, P cast to bf16 before P·V) in
# another summation order: the bf16 outputs may land one ulp apart
ONE_ULP = dict(rtol=2 ** -7, atol=2 ** -7)
BF = torch.bfloat16


def bf16(r, shape) -> np.ndarray:
    """Normal draws as float32 values that bf16 holds exactly."""
    x = r.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def chunk_case(cache_dtype: str, pos, m: int, seed: int = 0):
    """q [B, qh, m, d], pages [hkv, P, ps, d], a scrambled table whose
    entries past each row's chunk are -1, as numpy."""
    r = np.random.default_rng(seed)
    B, qh, hkv, d, P, ps, MP = len(pos), 4, 2, 8, 18, 4, 4
    case = {"q": bf16(r, (B, qh, m, d)), "k": bf16(r, (hkv, P, ps, d)),
            "v": bf16(r, (hkv, P, ps, d)),
            "pos": np.asarray(pos, np.int32)}
    perm = r.permutation(P)[:B * MP].reshape(B, MP)
    used = -(-(case["pos"] + m) // ps)
    case["table"] = np.where(np.arange(MP)[None] < used[:, None], perm,
                             -1).astype(np.int32)
    if cache_dtype == "int8":
        for name in ("k", "v"):
            q8, s = jquantize_kv(jnp.asarray(case[name], jnp.bfloat16))
            case[name], case[name + "_s"] = np.asarray(q8), np.asarray(s)
    return case


def jax_args(case):
    def j(a):
        return jnp.asarray(a, jnp.bfloat16 if a.dtype == np.float32
                           else a.dtype)
    kw = ({"k_s": jnp.asarray(case["k_s"]), "v_s": jnp.asarray(case["v_s"])}
          if "k_s" in case else {})
    return [j(case["q"]), j(case["k"]), j(case["v"]),
            jnp.asarray(case["table"]), jnp.asarray(case["pos"])], kw


def port_args(case):
    def t(a):
        x = torch.from_numpy(np.array(a))
        return x.to(BF) if a.dtype == np.float32 else x
    kw = ({"k_s": torch.from_numpy(np.array(case["k_s"])),
           "v_s": torch.from_numpy(np.array(case["v_s"]))}
          if "k_s" in case else {})
    return [t(case["q"]), t(case["k"]), t(case["v"]),
            torch.from_numpy(case["table"]),
            torch.from_numpy(case["pos"])], kw


# pos per row: a chunk that crosses a page boundary (3 .. 6 over pages of
# 4), one inside a page, one starting at 0, one filling the table's width
POS_CASES = {"m4": ([3, 8, 0, 12], 4), "m1": ([0, 5, 11, 15], 1),
             "m3": ([1, 4, 13, 6], 3)}


@pytest.mark.parametrize("case_name", sorted(POS_CASES))
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_chunk_attention_matches_reference(cache_dtype, case_name):
    pos, m = POS_CASES[case_name]
    case = chunk_case(cache_dtype, pos, m)
    jargs, jkw = jax_args(case)
    want = f32(jpk.paged_attention_chunk_ref(*jargs, m, **jkw))
    targs, tkw = port_args(case)
    out = tpk.paged_attention_chunk_ref(*targs, m, **tkw)
    assert out.dtype == BF and out.shape == case["q"].shape
    np.testing.assert_allclose(f32(out), want, **ONE_ULP)


def test_chunk_attention_masks_what_follows_each_row():
    """Row j sees columns <= pos + j: what a later position or a -1
    entry's clamped page holds changes nothing."""
    case = chunk_case("bf16", [3, 8, 0, 12], 4, seed=1)
    targs, _ = port_args(case)
    base = tpk.paged_attention_chunk_ref(*targs, 4)
    filled = dict(case, table=np.where(case["table"] < 0, 9, case["table"]))
    fargs, _ = port_args(filled)
    np.testing.assert_array_equal(
        f32(tpk.paged_attention_chunk_ref(*fargs, 4)), f32(base))
    # row 0 of slot 2 (pos 0) attends column 0 alone: its output is v there
    v0 = case["v"][:, case["table"][2, 0], 0]               # [hkv, d]
    np.testing.assert_allclose(f32(base)[2, :, 0],
                               np.repeat(v0, 2, axis=0), **ONE_ULP)


def test_decode_attention_is_the_chunk_at_one_row():
    case = chunk_case("int8", [0, 5, 11, 15], 1, seed=2)
    targs, tkw = port_args(case)
    q = targs[0][:, :, 0]
    got = tpk.paged_attention_ref(q, *targs[1:4], targs[4] + 1, **tkw)
    want = tpk.paged_attention_chunk_ref(*targs, 1, **tkw)[:, :, 0]
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_append_chunk_matches_reference(cache_dtype):
    """An m-token append crossing a page boundary, a row running off its
    table (past the width and onto -1 entries): bit-equal pools, and the
    pool's last page untouched (a -1 must drop, not wrap)."""
    CFG_KW = dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2,
                  n_layers=2, d_ff=128, max_seq=64)
    jcfg, tcfg = cfg_pair(**CFG_KW)
    L, hkv, d, ps, P, m = jcfg.n_layers, jcfg.kv_heads, jcfg.d_head, 4, 9, 5
    r = np.random.default_rng(4)
    k = bf16(r, (L, 3, hkv, m, d))
    table = np.array([[5, 2, 7], [1, 3, -1], [0, -1, -1]], np.int32)
    pos = np.array([3, 6, 2], np.int32)       # 3..7; 6..10 (8.. on -1)
    jc = jpk.init_paged_cache(jcfg, P, ps, cache_dtype)
    jc = jpk.append_chunk(jc, jnp.asarray(k, jnp.bfloat16),
                          -jnp.asarray(k, jnp.bfloat16), jnp.asarray(table),
                          jnp.asarray(pos), m)
    tc = tpk.init_paged_cache(tcfg, P, ps, cache_dtype, device="cpu")
    out = tpk.append_chunk(tc, torch.from_numpy(k).to(BF),
                           -torch.from_numpy(k).to(BF),
                           torch.from_numpy(table), torch.from_numpy(pos), m)
    assert out is tc
    for name in jc:
        np.testing.assert_array_equal(f32(tc[name]), f32(jc[name]))
        assert not tc[name][:, :, P - 1].any(), name
    if cache_dtype == "bf16":
        # row 0's position 4 (chunk column 1) is page 2, offset 0
        np.testing.assert_array_equal(f32(tc["k"][:, :, 2, 0]), k[:, 0, :, 1])


# -------------------------------------------------------------------------
# The chunk forward, chunked prefill and the decoder factory
# -------------------------------------------------------------------------

MODEL_CFGS = {
    "learned": dict(vocab=128, d_model=64, n_heads=4, n_layers=2,
                    d_ff=128, max_seq=64),
    "rope-gqa": dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2,
                     n_layers=2, d_ff=128, max_seq=64, pos_emb="rope"),
}
PROMPTS = [[3, 9, 27, 81, 115], [7] * 8, [1, 2, 3]]
STEPS, PS, TOTAL = 6, 4, 24


def model_case(name):
    jcfg, tcfg = cfg_pair(**MODEL_CFGS[name])
    jparams = jax_params(jcfg, seed=5)
    return jcfg, tcfg, jparams, to_torch(jparams)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(MODEL_CFGS))
def test_paged_chunk_logits_match_reference(name, cache_dtype):
    """After the same prefill, a 4-token chunk at each row's own position
    gives logits within the bf16 tolerance of the reference's, and pages
    within 2^-6 relative L2 error of the reference's."""
    jcfg, tcfg, jparams, tparams = model_case(name)
    prompt, lengths, table = ragged_case(PROMPTS, STEPS, PS, TOTAL)
    prompt = np.pad(prompt, ((0, 0), (0, (-prompt.shape[1]) % PS)))
    chunk = np.random.default_rng(6).integers(
        0, 128, (len(PROMPTS), 4)).astype(np.int32)
    jc = jpk.init_paged_cache(jcfg, TOTAL, PS, cache_dtype)
    ks, vs, _ = jpk._prefill_kv(jcfg, jparams, jnp.asarray(prompt))
    jc = jpk.scatter_prefill(jc, ks, vs, jnp.asarray(table))
    want, jc = jpk.paged_chunk_logits(jcfg, jparams, jc, jnp.asarray(chunk),
                                      jnp.asarray(lengths),
                                      jnp.asarray(table))
    tc = tpk.init_paged_cache(tcfg, TOTAL, PS, cache_dtype, device="cpu")
    tpk.prefill_pages_hidden(tcfg, tparams, tc, torch.from_numpy(prompt),
                             torch.from_numpy(table))
    got, out = tpk.paged_chunk_logits(
        tcfg, tparams, tc, torch.from_numpy(chunk), torch.from_numpy(lengths),
        torch.from_numpy(table))
    assert out is tc and got.shape == (len(PROMPTS), 4, 128)
    want = f32(want)
    np.testing.assert_allclose(f32(got), want, rtol=0,
                               atol=float(logit_tol(np.abs(want).max())))
    # the pages: layer 0's KV rounds like the reference's; deeper layers'
    # inherit the residual stream's one-ulp flips, so each leaf is held
    # to 2^-6 relative L2 error
    for n in jc:
        diff = np.linalg.norm(f32(tc[n]) - f32(jc[n]))
        assert diff <= 2 ** -6 * np.linalg.norm(f32(jc[n])), n


@pytest.mark.parametrize("name", sorted(MODEL_CFGS))
def test_paged_chunked_prefill_matches_reference(name):
    """Chunked prefill in 4-token pieces (ragged rows whose last real
    token lands in different pieces): last-position logits within the
    bf16 tolerance of the reference's and of the port's dense prefill."""
    jcfg, tcfg, jparams, tparams = model_case(name)
    prompt, lengths, table = ragged_case(PROMPTS, STEPS, PS, TOTAL)
    jc = jpk.init_paged_cache(jcfg, TOTAL, PS)
    _, want = jpk.paged_chunked_prefill(jcfg, jparams, jc,
                                        jnp.asarray(prompt),
                                        jnp.asarray(lengths),
                                        jnp.asarray(table), 4)
    tc = tpk.init_paged_cache(tcfg, TOTAL, PS, device="cpu")
    _, got = tpk.paged_chunked_prefill(
        tcfg, tparams, tc, torch.from_numpy(prompt).long(),
        torch.from_numpy(lengths), torch.from_numpy(table), 4)
    tol = float(logit_tol(np.abs(f32(want)).max()))
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=tol)
    dense = tpk.prefill_pages(
        tcfg, tparams, tpk.init_paged_cache(tcfg, TOTAL, PS, device="cpu"),
        torch.from_numpy(prompt).long(), torch.from_numpy(lengths),
        torch.from_numpy(table))
    np.testing.assert_allclose(f32(got), f32(dense), rtol=0, atol=tol)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tpk.paged_chunked_prefill(tcfg, tparams, tc,
                                  torch.from_numpy(prompt).long(),
                                  torch.from_numpy(lengths),
                                  torch.from_numpy(table), 3)


@pytest.mark.parametrize("prefill_chunk", [None, 4, 3])
@pytest.mark.parametrize("name", sorted(MODEL_CFGS))
def test_make_paged_decoder_matches_reference(name, prefill_chunk):
    """The decoder factory, with and without chunked prefill: tokens
    follow the reference's ``make_paged_decoder`` up to a bf16 near-tie,
    and the port's tokens with ``prefill_chunk`` equal its tokens
    without."""
    jcfg, tcfg, jparams, tparams = model_case(name)
    prompt, lengths, table = ragged_case(PROMPTS, STEPS, PS, TOTAL)
    jdec = jpk.make_paged_decoder(jcfg, steps=STEPS, total_pages=TOTAL,
                                  page_size=PS, interpret=True)
    ref = np.asarray(jdec(jparams, jnp.asarray(prompt), jnp.asarray(table),
                          lengths=jnp.asarray(lengths)))
    _, want_lg = jax_stream(jcfg, jparams, prompt, lengths, table, STEPS,
                            page_size=PS, total_pages=TOTAL)
    tdec = tpk.make_paged_decoder(tcfg, steps=STEPS, total_pages=TOTAL,
                                  page_size=PS, prefill_chunk=prefill_chunk,
                                  device="cpu")
    got = tdec(tparams, prompt, table, lengths)
    assert got.shape == (len(PROMPTS), STEPS) and got.dtype == torch.int32
    for b in range(len(PROMPTS)):
        assert_greedy_agrees(ref[b], want_lg[:, b], got[b].tolist())
    plain = tpk.make_paged_decoder(tcfg, steps=STEPS, total_pages=TOTAL,
                                   page_size=PS, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), plain(tparams, prompt, table, lengths).numpy())


def test_make_paged_decoder_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tcfg = cfg_pair(**MODEL_CFGS["learned"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpk.make_paged_decoder(tcfg, steps=2, total_pages=4, page_size=4)
