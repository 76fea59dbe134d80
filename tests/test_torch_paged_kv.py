"""Paged KV memory and paged decode of the PyTorch port
(tpu_dra_torch/workloads/paged_kv.py) against the JAX reference
(tpu_dra/workloads/paged_kv.py).

On the CPU the attention wrapper takes its plain version, so these tests
hold that plain version to the reference's Pallas kernel (run with
``interpret=True``) and to the reference's own oracle; the CUDA kernel is
held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    argmax_tol,
    cfg_pair,
    f32,
    jax_params,
    jax_stream,
    logit_tol,
    port_forced_logits,
    ragged_case,
    to_torch,
    top2_margin,
    assert_greedy_agrees,
)

from tpu_dra.workloads import paged_kv as jpk
from tpu_dra.workloads.quant import quantize_kv as jquantize_kv
from tpu_dra_torch.workloads import paged_kv as tpk
from tpu_dra_torch.workloads.paged_kv import PagePool

# same rounding points on both sides, different summation order: the
# bf16 outputs may land one ulp (2^-8 relative) apart
ONE_ULP = dict(rtol=2 ** -7, atol=2 ** -7)
# the reference's own kernel-vs-oracle tolerances
# (tests/test_paged_kv.py): the kernel rounds its scores at other points
KERNEL_TOL = {"bf16": dict(rtol=0.05, atol=0.05),
              "int8": dict(rtol=0.08, atol=0.08)}


# -------------------------------------------------------------------------
# PagePool (mirrors tests/test_paged_kv.py)
# -------------------------------------------------------------------------


def test_pool_alloc_free_roundtrip():
    pool = PagePool(8, 4)
    a = pool.alloc(3)
    b = pool.alloc(2)
    assert len(set(a) | set(b)) == 5          # disjoint
    assert pool.free_pages == 3
    pool.free(a)
    assert pool.free_pages == 6
    c = pool.alloc(6)
    assert len(set(c) | set(b)) == 8          # reuses freed pages
    with pytest.raises(MemoryError):
        pool.alloc(1 + pool.free_pages)


def test_pool_pages_for_and_table_row():
    pool = PagePool(16, 4)
    assert [pool.pages_for(n) for n in (1, 4, 5)] == [1, 1, 2]
    row = pool.table_row([7, 3], max_pages=4)
    assert list(row) == [7, 3, -1, -1]
    assert row.dtype == np.int32


def test_pool_refcounts_and_double_free():
    pool = PagePool(4, 2)
    assert pool.alloc(0) == [] and pool.free_pages == 4
    a = pool.alloc(2)
    pool.ref(a[:1])
    pool.free(a)
    assert pool.free_pages == 3               # a[0] still referenced
    pool.free(a[:1])
    assert pool.free_pages == 4
    with pytest.raises(ValueError, match="double free"):
        pool.free(a[:1])
    with pytest.raises(ValueError, match="non-live"):
        pool.ref([0])


# -------------------------------------------------------------------------
# Paged attention: the plain version against the reference
# -------------------------------------------------------------------------


def attn_case(cache_dtype: str, lengths, seed: int = 0):
    """q [B, qh, d] bf16, pages [hkv, P, ps, d], scrambled tables with
    -1 tails past each slot's pages, as numpy (bf16 as float32 values
    that bf16 holds exactly)."""
    r = np.random.default_rng(seed)
    B, qh, hkv, d, P, ps, MP = len(lengths), 4, 2, 8, 12, 4, 4

    def bf16(shape):
        x = r.standard_normal(shape).astype(np.float32)
        return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    q, kp, vp = bf16((B, qh, d)), bf16((hkv, P, ps, d)), bf16((hkv, P, ps, d))
    perm = r.permutation(P)[:B * MP].reshape(B, MP).astype(np.int32)
    used = -(-np.asarray(lengths) // ps)
    table = np.where(np.arange(MP)[None] < used[:, None], perm, -1)
    case = {"q": q, "k": kp, "v": vp, "table": table.astype(np.int32),
            "lengths": np.asarray(lengths, np.int32)}
    if cache_dtype == "int8":
        kq, ks = jquantize_kv(jnp.asarray(kp, jnp.bfloat16))
        vq, vs = jquantize_kv(jnp.asarray(vp, jnp.bfloat16))
        case.update(k=np.asarray(kq), v=np.asarray(vq), k_s=np.asarray(ks),
                    v_s=np.asarray(vs))
    return case


def run_jax(fn, case, **kw):
    args = [jnp.asarray(case["q"], jnp.bfloat16)]
    for name in ("k", "v"):
        a = case[name]
        args.append(jnp.asarray(a, jnp.bfloat16 if a.dtype != np.int8
                                else jnp.int8))
    args += [jnp.asarray(case["table"]), jnp.asarray(case["lengths"])]
    if "k_s" in case:
        args += [jnp.asarray(case["k_s"]), jnp.asarray(case["v_s"])]
    return f32(fn(*args, **kw))


def run_port(fn, case):
    def t(a):         # bf16 values travel as float32; int8 pages as-is
        x = torch.from_numpy(np.array(a))
        return x.to(torch.bfloat16) if a.dtype == np.float32 else x
    args = [t(case["q"]), t(case["k"]), t(case["v"]),
            torch.from_numpy(case["table"]), torch.from_numpy(case["lengths"])]
    if "k_s" in case:
        args += [torch.from_numpy(np.array(case["k_s"])),
                 torch.from_numpy(np.array(case["v_s"]))]
    out = fn(*args)
    assert out.dtype == torch.bfloat16
    return f32(out)


LENGTH_CASES = {
    "ragged": [1, 16, 9],                 # 1 token, full MP*ps, mid-page
    "zero-length": [0, 5, 4],             # empty slot, page boundary
}


@pytest.mark.parametrize("lengths", sorted(LENGTH_CASES))
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_plain_attention_matches_reference_oracle(cache_dtype, lengths):
    case = attn_case(cache_dtype, LENGTH_CASES[lengths])
    want = run_jax(jpk.paged_attention_ref, case)
    got = run_port(tpk.paged_attention_ref, case)
    np.testing.assert_allclose(got, want, **ONE_ULP)
    if lengths == "zero-length":
        assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("lengths", sorted(LENGTH_CASES))
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_plain_attention_matches_reference_kernel(cache_dtype, lengths):
    case = attn_case(cache_dtype, LENGTH_CASES[lengths], seed=1)
    want = run_jax(jpk.paged_attention, case, interpret=True)
    got = run_port(tpk.paged_attention_ref, case)
    np.testing.assert_allclose(got, want, **KERNEL_TOL[cache_dtype])


def test_sentinel_pages_contribute_nothing():
    """-1 entries clamp to page 0; the length mask must remove them."""
    case = attn_case("bf16", [4, 4, 4], seed=2)
    full = dict(case, table=np.where(case["table"] < 0, 5, case["table"]))
    a = run_port(tpk.paged_attention_ref, case)
    b = run_port(tpk.paged_attention_ref, full)
    np.testing.assert_array_equal(a, b)


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    case = attn_case("bf16", LENGTH_CASES["ragged"])
    before = tpk.paged_attention.launches
    got = run_port(tpk.paged_attention, case)
    np.testing.assert_array_equal(got, run_port(tpk.paged_attention_ref,
                                                case))
    assert tpk.paged_attention.launches == before


def test_wrapper_rejects_other_devices():
    case = attn_case("bf16", LENGTH_CASES["ragged"])
    q = torch.from_numpy(case["q"]).to(torch.bfloat16).to("meta")
    k = torch.from_numpy(case["k"]).to(torch.bfloat16)
    with pytest.raises(ValueError):
        tpk.paged_attention(q, k, k, torch.from_numpy(case["table"]),
                            torch.from_numpy(case["lengths"]))


# -------------------------------------------------------------------------
# Page writes
# -------------------------------------------------------------------------

CFG_KW = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_seq=64)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_scatter_prefill_then_append_matches_reference(cache_dtype):
    jcfg, tcfg = cfg_pair(**CFG_KW)
    L, hkv, d = jcfg.n_layers, jcfg.kv_heads, jcfg.d_head
    ps, P, B, S = 4, 10, 2, 8
    r = np.random.default_rng(3)
    ks = np.asarray(jnp.asarray(r.standard_normal((L, B, hkv, S, d)),
                                jnp.bfloat16), np.float32)
    k1 = np.asarray(jnp.asarray(r.standard_normal((L, B, hkv, d)),
                                jnp.bfloat16), np.float32)
    table = np.array([[5, 2, 7], [1, 8, -1]], np.int32)
    lengths = np.array([8, 4], np.int32)

    jc = jpk.init_paged_cache(jcfg, P, ps, cache_dtype)
    jc = jpk.scatter_prefill(jc, jnp.asarray(ks, jnp.bfloat16),
                             -jnp.asarray(ks, jnp.bfloat16),
                             jnp.asarray(table))
    jc = jpk.append_token(jc, jnp.asarray(k1, jnp.bfloat16),
                          -jnp.asarray(k1, jnp.bfloat16), jnp.asarray(table),
                          jnp.asarray(lengths))
    tc = tpk.init_paged_cache(tcfg, P, ps, cache_dtype, device="cpu")
    bf = torch.bfloat16
    out = tpk.scatter_prefill(tc, torch.from_numpy(ks).to(bf),
                              -torch.from_numpy(ks).to(bf),
                              torch.from_numpy(table))
    assert out is tc                                   # written in place
    tpk.append_token(tc, torch.from_numpy(k1).to(bf),
                     -torch.from_numpy(k1).to(bf), torch.from_numpy(table),
                     torch.from_numpy(lengths))
    assert sorted(tc) == sorted(jc)
    for name in jc:
        np.testing.assert_array_equal(f32(tc[name]), f32(jc[name]))
    # sequence 0's second page (positions 4..7) lives in page 2, and its
    # append at position 8 landed in page 7, offset 0
    if cache_dtype == "bf16":
        np.testing.assert_array_equal(f32(tc["k"][:, :, 2]), ks[:, 0, :, 4:8])
        np.testing.assert_array_equal(f32(tc["k"][:, :, 7, 0]), k1[:, 0])


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_retired_row_never_writes_last_page(cache_dtype):
    """An all-(-1) table row (a retired slot) writes nothing.  torch
    indexing would wrap -1 to the pool's LAST page; the masks must stop
    that for the prefill scatter and the token append alike."""
    _, tcfg = cfg_pair(**CFG_KW)
    L, hkv, d = tcfg.n_layers, tcfg.kv_heads, tcfg.d_head
    ps, P, B, S = 4, 6, 2, 8
    cache = tpk.init_paged_cache(tcfg, P, ps, cache_dtype, device="cpu")
    ks = torch.ones((L, B, hkv, S, d), dtype=torch.bfloat16)
    table = torch.tensor([[0, 1], [-1, -1]], dtype=torch.int32)
    tpk.scatter_prefill(cache, ks, 2 * ks, table)
    for name in cache:
        assert not cache[name][:, :, P - 1].any(), name
    k1 = torch.full((L, B, hkv, d), 7.0, dtype=torch.bfloat16)
    # seq 0 at position 8 is past its 2-entry row: dropped as well
    tpk.append_token(cache, k1, k1, table, torch.tensor([8, 4]))
    for name in cache:
        assert not cache[name][:, :, P - 1].any(), name
        assert not cache[name][:, :, 2:].any(), name
    # a valid row's append still lands
    table2 = torch.tensor([[0, 1, 2], [-1, -1, -1]], dtype=torch.int32)
    tpk.append_token(cache, k1, k1, table2, torch.tensor([8, 0]))
    assert cache["k"][:, :, 2, 0].any()
    assert not cache["k"][:, :, P - 1].any()


def nonzero_append(cache, k_new, v_new, table, lengths, m):
    """The port's append before it dropped on the device: the kept
    entries selected with ``torch.nonzero`` (a host sync), written, the
    rest left alone.  The oracle of the sync-free append."""
    ps, P = cache["k"].shape[3], cache["k"].shape[2]
    MP = table.shape[1]
    posn = lengths.long().reshape(-1, 1) + torch.arange(m)[None, :]
    pidx = posn // ps
    ids = table.long().gather(1, pidx.clamp(0, MP - 1))
    ok = (posn >= 0) & (pidx < MP) & (ids >= 0) & (ids < P)
    rows, cols = torch.nonzero(ok, as_tuple=True)
    ids, off = ids[rows, cols], (posn % ps)[rows, cols]
    for name, col in tpk._kv_cols(cache, k_new, v_new).items():
        buf = cache[name]
        buf[:, :, ids, off] = col[:, rows, :, cols].permute(1, 2, 0, 3).to(
            buf.dtype)


def append_case(seed: int, m: int, cache_dtype: str):
    """A filled pool, a random table (a -1 row, -1 tails, pages in no
    row, the last page in none) and start positions that cross pages,
    fall past a row's pages or its width, or below 0."""
    _, tcfg = cfg_pair(**CFG_KW)
    L, hkv, d = tcfg.n_layers, tcfg.kv_heads, tcfg.d_head
    ps, P, B, MP = 4, 12, 5, 3
    r = np.random.default_rng(seed)
    cache = tpk.init_paged_cache(tcfg, P, ps, cache_dtype, device="cpu")
    for name, buf in cache.items():
        buf.copy_(torch.from_numpy(
            r.integers(-100, 100, buf.shape)).to(buf.dtype))
    pages = r.permutation(P - 1)                  # the last page: in no row
    table = np.full((B, MP), -1, np.int32)
    used = 0
    for b in range(1, B):                         # row 0 stays all -1
        n = int(r.integers(1, MP + 1))
        table[b, :n] = pages[used:used + n]
        used += n
    lengths = r.integers(-m - 1, MP * ps + 2, B).astype(np.int32)
    lengths[1] = ps - 1                           # crosses a page when m > 1
    k_new = torch.from_numpy(r.standard_normal((L, B, hkv, m, d))).to(
        torch.bfloat16)
    v_new = torch.from_numpy(r.standard_normal((L, B, hkv, m, d))).to(
        torch.bfloat16)
    return cache, k_new, v_new, torch.from_numpy(table), \
        torch.from_numpy(lengths)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_sync_free_append_equals_the_nonzero_append(cache_dtype, m, seed):
    """The device-side drop writes the bits the nonzero selection wrote,
    over -1 rows, page crossings and positions past a row's pages or
    below 0, and never writes the pool's last page (no row names it)."""
    cache, k_new, v_new, table, lengths = append_case(seed, m, cache_dtype)
    want = {name: buf.clone() for name, buf in cache.items()}
    last = {name: buf[:, :, -1].clone() for name, buf in cache.items()}
    nonzero_append(want, k_new, v_new, table, lengths, m)
    out = tpk.append_chunk(cache, k_new, v_new, table, lengths, m)
    assert out is cache
    for name in cache:
        torch.testing.assert_close(cache[name], want[name], rtol=0, atol=0)
        torch.testing.assert_close(cache[name][:, :, -1], last[name],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_all_dropped_append_leaves_every_page_alone(cache_dtype):
    """With no entry kept (every row -1, or every position past its
    row), the sync-free append rewrites page 0's old values and changes
    nothing."""
    cache, k_new, v_new, table, lengths = append_case(9, 2, cache_dtype)
    before = {name: buf.clone() for name, buf in cache.items()}
    tpk.append_chunk(cache, k_new, v_new, torch.full_like(table, -1),
                     lengths, 2)
    tpk.append_chunk(cache, k_new, v_new, table,
                     torch.full_like(lengths, 1 << 20), 2)
    for name in cache:
        torch.testing.assert_close(cache[name], before[name], rtol=0, atol=0)


# -------------------------------------------------------------------------
# Paged greedy decode against the reference
# -------------------------------------------------------------------------

DECODE_CFGS = {
    "learned": dict(CFG_KW),
    "rope-gqa": dict(vocab=128, d_model=64, n_heads=4, n_kv_heads=2,
                     n_layers=2, d_ff=128, max_seq=64, pos_emb="rope"),
}
PROMPTS = [[3, 9, 27, 81 % 128, 115], [7] * 8, [1, 2, 3]]   # ragged
STEPS, PS, TOTAL = 6, 4, 24


def decode_case(name, cache_dtype="bf16"):
    jcfg, tcfg = cfg_pair(**DECODE_CFGS[name])
    params = jax_params(jcfg, seed=5)
    prompt, lengths, table = ragged_case(PROMPTS, STEPS, PS, TOTAL)
    want_tok, want_lg = jax_stream(
        jcfg, params, prompt, lengths, table, STEPS, page_size=PS,
        total_pages=TOTAL, cache_dtype=cache_dtype)
    return tcfg, to_torch(params), prompt, lengths, table, want_tok, \
        want_lg


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(DECODE_CFGS))
def test_paged_step_logits_teacher_forced(name, cache_dtype):
    """Fed the reference's own greedy stream, every step's logits agree
    within the bf16 tolerance, and the argmax agrees wherever the
    reference's top-2 margin is wider than that tolerance allows."""
    tcfg, tparams, prompt, lengths, table, want_tok, want_lg = \
        decode_case(name, cache_dtype)
    got_lg = port_forced_logits(tcfg, tparams, prompt, lengths, table,
                                want_tok, page_size=PS, total_pages=TOTAL,
                                cache_dtype=cache_dtype)
    assert got_lg.shape == want_lg.shape
    np.testing.assert_allclose(got_lg, want_lg, rtol=0,
                               atol=float(logit_tol(np.abs(want_lg).max())))
    decisive = top2_margin(want_lg) > argmax_tol(want_lg)
    assert decisive.mean() > 0.5          # the check has teeth
    np.testing.assert_array_equal(np.argmax(got_lg, -1)[decisive],
                                  want_tok.T[decisive])


@pytest.mark.parametrize("name", sorted(DECODE_CFGS))
def test_paged_greedy_decode_matches_reference(name):
    """Free-running greedy decode, ragged prompts, scrambled pages: the
    port's tokens follow the reference's ``paged_greedy_decode`` up to a
    bf16 near-tie, if any."""
    tcfg, tparams, prompt, lengths, table, want_tok, want_lg = \
        decode_case(name)
    jcfg, _ = cfg_pair(**DECODE_CFGS[name])
    ref = np.asarray(jpk.paged_greedy_decode(
        jcfg, jax_params(jcfg, seed=5), jnp.asarray(prompt),
        jnp.asarray(table), steps=STEPS, total_pages=TOTAL, page_size=PS,
        lengths=jnp.asarray(lengths), interpret=True))
    got = tpk.paged_greedy_decode(
        tcfg, tparams, torch.from_numpy(prompt).long(),
        torch.from_numpy(table), steps=STEPS, total_pages=TOTAL,
        page_size=PS, lengths=torch.from_numpy(lengths))
    assert got.shape == (len(PROMPTS), STEPS) and got.dtype == torch.int32
    for b in range(len(PROMPTS)):
        assert_greedy_agrees(ref[b], want_lg[:, b], got[b].tolist())
