"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: each test skips where CUDA is absent, and the
suite runs them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

(chip_smoke.py holds the same kernels to the same versions at the
serving and training paths' full shapes; these cover the other shapes
the kernels take, and the wrappers' refusals.)
"""

from __future__ import annotations

import pytest
import torch

from tpu_dra_torch.workloads import paged_kv as tpk
from tpu_dra_torch.workloads.quant import quantize_kv

pytestmark = pytest.mark.cuda

# the reference's elementwise kernel-vs-oracle tolerances
# (tests/test_paged_kv.py); each slot is also held to its own scale
# (paged_kv.SLOT_REL_TOL, see tests/test_torch_kernel_check.py)
TOL = {False: 0.05, True: 0.08}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_paged_attention_kernel_matches_plain(g, dh, quantized):
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(g * 1000 + dh)
    hkv, P, ps, MP = 2, 24, 16, 6
    lengths = torch.tensor([0, 1, ps, ps + 1, 37, MP * ps, 5, 90],
                           dtype=torch.int32, device=dev)
    B = lengths.numel()
    q = torch.randn((B, g * hkv, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randn((hkv, P, ps, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((hkv, P, ps, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    used = (lengths + ps - 1) // ps
    pages = torch.randint(0, P, (B, MP), generator=gen, device=dev,
                          dtype=torch.int32)
    table = torch.where(torch.arange(MP, device=dev)[None] < used[:, None],
                        pages, torch.full_like(pages, -1)).contiguous()
    extra = {}
    if quantized:
        k, k_s = quantize_kv(k)
        v, v_s = quantize_kv(v)
        extra = dict(k_s=k_s, v_s=v_s)
    before = tpk.paged_attention.launches
    got = tpk.paged_attention(q, k, v, table, lengths, **extra)
    torch.cuda.synchronize()
    assert tpk.paged_attention.launches == before + 1
    want = tpk.paged_attention_ref(q, k, v, table, lengths, **extra)
    tol = TOL[quantized]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    rel = tpk.slot_rel_err(got, want)
    assert float(rel.max()) <= tpk.SLOT_REL_TOL, rel
    assert bool((got[0] == 0).all())


def _paged_case(dev, gen, lengths, g, dh, quantized, hkv=2, P=40, ps=64,
                MP=16):
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    B = lengths.numel()
    q = torch.randn((B, g * hkv, dh), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((hkv, P, ps, dh), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    used = (lengths + ps - 1) // ps
    pages = torch.randint(0, P, (B, MP), generator=gen, device=dev,
                          dtype=torch.int32)
    table = torch.where(torch.arange(MP, device=dev)[None] < used[:, None],
                        pages, torch.full_like(pages, -1)).contiguous()
    extra = {}
    if quantized:
        k, k_s = quantize_kv(k)
        v, v_s = quantize_kv(v)
        extra = dict(k_s=k_s, v_s=v_s)
    return (q, k, v, table, lengths), extra


def test_speculative_paged_engine_launches_the_kernel_per_draft_step():
    """One speculative paged batch on the card: the draft's steps launch
    the paged-attention kernel exactly draft layers x chunk times a pass
    (the target's chunk verify is plain PyTorch), and every answer has
    its length and equals the plain paged engine's up to a near-tie (here
    only held for its length; chip_smoke.py holds it at full width)."""
    dev = card()
    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    from tpu_dra_torch.workloads.spec_draft import truncate_draft
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(vocab=256, d_model=256, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=512, max_seq=256, pos_emb="rope")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    dcfg, dparams = truncate_draft(cfg, params, 1)
    eng = ContinuousEngine(cfg, params, slots=4, chunk=4, kv_layout="paged",
                           page_size=16, device=dev, draft=(dcfg, dparams))
    try:
        assert len(eng.submit([1, 2, 3], 2, timeout=300)) == 2
        eng.reset_stats()
        before = tpk.paged_attention.launches
        handles = [eng.submit_async([5 + i] * (3 + 5 * i), 10)
                   for i in range(4)]
        for h in handles:
            assert h.done.wait(300) and h.error is None, h.error
        launches = tpk.paged_attention.launches - before
        st = eng.stats()
    finally:
        eng.shutdown()
    assert st["spec_target_passes"] >= 3
    assert launches == dcfg.n_layers * 4 * st["spec_target_passes"]
    assert all(len(h.tokens) == 10 for h in handles)


def test_prefix_batch_on_pages_shares_pages_and_launches_the_kernel():
    """A batch of prefix joins on pages on the card: every decode step
    launches the paged-attention kernel once a layer over the shared
    prefix pages, the pages in use stay within the prefix's shared pages
    and the joiners' own, every reference comes back, and each answer
    has its length."""
    dev = card()
    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(vocab=256, d_model=256, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=512, max_seq=256, pos_emb="rope")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    eng = ContinuousEngine(cfg, params, slots=4, chunk=4, kv_layout="paged",
                           page_size=16, total_pages=24, device=dev)
    try:
        pid = eng.register_prefix(list(range(40, 80)))   # 2 pages + 8
        pages = list(eng._prefixes[pid].pages)
        assert len(pages) == 2
        assert len(eng.submit([1, 2, 3], 2, prefix_id=pid,
                              timeout=300)) == 2
        eng.reset_stats()
        before = tpk.paged_attention.launches
        handles = [eng.submit_async([5 + i] * (3 + 5 * i), 12,
                                    prefix_id=pid) for i in range(4)]
        for h in handles:
            assert h.done.wait(300) and h.error is None, h.error
        launches = tpk.paged_attention.launches - before
        st = eng.stats()
        refs = [eng.pool._refs.get(p, 0) for p in pages]
    finally:
        eng.shutdown()
    assert launches == cfg.n_layers * st["decode_steps"] > 0
    assert st["peak_active"] == 4
    assert st["kv_pages_peak_used"] == 2 + st["kv_pages_own_at_peak"]
    assert st["kv_pages_free"] == st["kv_pages_total"] - 2 and refs == [1, 1]
    assert all(len(h.tokens) == 12 for h in handles)


def test_paged_attention_kernel_around_its_spans():
    """The split-page kernel where its work items end: spans that end on a
    page edge (lengths 64, 128, 256: one, two and four whole pages), one
    slot of the full 1024 tokens, every slot at length 0, and int8 pages
    at g 1 and 8; every case also called twice, bit-equal."""
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(91)
    edge = [64, 128, 256, 127, 129, 192, 1, 0]
    cases = [(edge, 4, 128, False), ([1024], 4, 128, False),
             ([0] * 6, 4, 128, False), (edge, 1, 128, True),
             (edge + [1024, 513], 8, 64, True), ([1024, 700], 1, 64, True)]
    for lengths, g, dh, quantized in cases:
        args, extra = _paged_case(dev, gen, lengths, g, dh, quantized)
        before = tpk.paged_attention.launches
        got = tpk.paged_attention(*args, **extra)
        again = tpk.paged_attention(*args, **extra)
        torch.cuda.synchronize()
        assert tpk.paged_attention.launches == before + 2
        assert torch.equal(got, again), (lengths, g, dh, quantized)
        want = tpk.paged_attention_ref(*args, **extra)
        tol = TOL[quantized]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        rel = tpk.slot_rel_err(got, want)
        assert float(rel.max()) <= tpk.SLOT_REL_TOL, (lengths, rel)
        for b, n in enumerate(lengths):
            if n == 0:
                assert bool((got[b] == 0).all())


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = card()
    q = torch.zeros((2, 4, 32), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((2, 4, 16, 32), dtype=torch.bfloat16, device=dev)
    table = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="Dh"):
        tpk.paged_attention(q, k, k, table, lengths)
    with pytest.raises(ValueError, match="int32"):
        tpk.paged_attention(q.new_zeros((2, 4, 64)),
                            k.new_zeros((2, 4, 16, 64)),
                            k.new_zeros((2, 4, 16, 64)), table.long(),
                            lengths)


# --------------------------------------------------------------------------
# flash attention: forward, dQ and dK/dV kernels (workloads/flash.py)
# --------------------------------------------------------------------------

def _flash_close(got, want, row_tol):
    from tpu_dra_torch.workloads import flash as tf
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=tf.ELEM_TOL, atol=tf.ELEM_TOL)
    assert float(tf.row_rel_err(got, want).max()) <= row_tol


@pytest.mark.parametrize("shape", [(256, 256, 1024, 128), (64, 16, 1024, 128)],
                         ids=["flagship", "gqa-run"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_kernels_match_plain_at_path_shapes(shape, causal):
    _flash_kernels_match_plain(*shape, causal)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 1000])
def test_flash_kernels_match_plain_at_edge_lengths(s, causal, g, d):
    _flash_kernels_match_plain(8, 8 // g, s, d, causal)


@pytest.mark.parametrize("s,sk", [(100, 300), (300, 70)])
def test_flash_kernels_match_plain_across_lengths(s, sk):
    """Non-causal attention of S queries over Sk keys: the ragged key
    tail and the dK/dV grid over Sk."""
    _flash_kernels_match_plain(8, 2, s, 128, False, sk)


def _flash_kernels_match_plain(bh, bhkv, s, d, causal, sk=None):
    from tpu_dra_torch.workloads import flash as tf
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(bh * 7 + s * 3 + d + int(causal))

    def draw(n, length):
        return torch.randn((n, length, d), generator=gen, device=dev).to(
            torch.bfloat16)
    sk = sk or s
    q, k, v, do = draw(bh, s), draw(bhkv, sk), draw(bhkv, sk), draw(bh, s)
    before = (tf.flash_attn_fwd.launches, tf.flash_bwd_dq.launches,
              tf.flash_bwd_dkdv.launches)
    out, l2 = tf.flash_attn_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    want_out, want_l2 = tf.flash_attn_fwd_ref(q, k, v, causal)
    _flash_close(out, want_out, tf.ROW_TOL["out"])
    assert float((l2 - want_l2).abs().max()) <= tf.L2_ATOL
    qs = tf._prescale(q).contiguous()
    dd = (do.float() * want_out.float()).sum(-1, keepdim=True)
    dq = tf.flash_bwd_dq(qs, k, v, do, want_l2, dd, causal)
    dk, dv = tf.flash_bwd_dkdv(qs, k, v, do, want_l2, dd, causal)
    torch.cuda.synchronize()
    _flash_close(dq, tf.flash_bwd_dq_ref(qs, k, v, do, want_l2, dd, causal),
                 tf.ROW_TOL["dq"])
    rk, rv = tf.flash_bwd_dkdv_ref(qs, k, v, do, want_l2, dd, causal)
    _flash_close(dk, rk, tf.ROW_TOL["dk"])
    _flash_close(dv, rv, tf.ROW_TOL["dv"])
    assert (tf.flash_attn_fwd.launches, tf.flash_bwd_dq.launches,
            tf.flash_bwd_dkdv.launches) == tuple(n + 1 for n in before)


def _flash_fwd_matches_plain(bh, bhkv, s, d, causal, sk=None):
    """The forward kernel alone against flash_attn_fwd_ref; returns its
    outputs."""
    from tpu_dra_torch.workloads import flash as tf
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(bh * 11 + s * 5 + (sk or 0) + d + int(causal))
    sk = sk or s
    q = torch.randn((bh, s, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((bhkv, sk, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    before = tf.flash_attn_fwd.launches
    out, l2 = tf.flash_attn_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert tf.flash_attn_fwd.launches == before + 1
    want_out, want_l2 = tf.flash_attn_fwd_ref(q, k, v, causal)
    _flash_close(out, want_out, tf.ROW_TOL["out"])
    assert float((l2 - want_l2).abs().max()) <= tf.L2_ATOL
    return (q, k, v), (out, l2)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [127, 128, 129, 255, 257])
def test_flash_fwd_matches_plain_around_its_tiles(s, causal, g, d):
    """Lengths around the forward's 128-row q blocks (two 64-row halves)
    and 128-key tiles: one short of a tile, a tile, one over, and so on
    at two tiles."""
    _flash_fwd_matches_plain(8, 8 // g, s, d, causal)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_fwd_matches_plain_at_the_ring_block(causal):
    """The DP×SP step's per-rank block: [1024, 256, 128] (4 ranks × 16
    sequences × 16 heads of 256 rows), causal on the diagonal, full off
    it."""
    _flash_fwd_matches_plain(1024, 1024, 256, 128, causal)


@pytest.mark.parametrize("s,sk", [(256, 200), (130, 333), (64, 129)])
def test_flash_fwd_matches_plain_with_a_ragged_key_tile(s, sk):
    """Non-causal Sk not a multiple of the 128-key tile: the zero-filled
    keys past Sk score 0 and must be masked."""
    _flash_fwd_matches_plain(8, 2, s, 128, False, sk)


def test_flash_fwd_is_deterministic():
    """The forward has no atomics: two launches on the same inputs are
    bit-equal."""
    from tpu_dra_torch.workloads import flash as tf
    (q, k, v), (out, l2) = _flash_fwd_matches_plain(64, 16, 1024, 128, True)
    again, l2_again = tf.flash_attn_fwd(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(l2, l2_again)


def _split_bwd_matches_plain(bh, bhkv, s, d, causal, sk=None):
    """The dQ and dK/dV kernels alone against their plain versions, on the
    plain forward's out and l2; each launches once.  Returns the kernels'
    inputs and outputs."""
    from tpu_dra_torch.workloads import flash as tf
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(bh * 13 + s * 7 + (sk or 0) + d + int(causal))
    sk = sk or s

    def draw(n, length):
        return torch.randn((n, length, d), generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v, do = draw(bh, s), draw(bhkv, sk), draw(bhkv, sk), draw(bh, s)
    out, l2 = tf.flash_attn_fwd_ref(q, k, v, causal)
    qs = tf._prescale(q).contiguous()
    dd = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (qs, k, v, do, l2, dd, causal)
    before = (tf.flash_bwd_dq.launches, tf.flash_bwd_dkdv.launches)
    dq = tf.flash_bwd_dq(*args)
    dk, dv = tf.flash_bwd_dkdv(*args)
    torch.cuda.synchronize()
    assert (tf.flash_bwd_dq.launches, tf.flash_bwd_dkdv.launches) == (
        before[0] + 1, before[1] + 1)
    _flash_close(dq, tf.flash_bwd_dq_ref(*args), tf.ROW_TOL["dq"])
    rk, rv = tf.flash_bwd_dkdv_ref(*args)
    _flash_close(dk, rk, tf.ROW_TOL["dk"])
    _flash_close(dv, rv, tf.ROW_TOL["dv"])
    return args, (dq, dk, dv)


@pytest.mark.parametrize("g,d", [(1, 128), (4, 64)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s", [127, 129, 192, 255, 257])
def test_split_backward_matches_plain_around_its_tiles(s, causal, g, d):
    """Lengths around the dQ kernel's 128-row q tiles (two 64-row halves)
    and 64-key K/V tiles, and the dK/dV kernel's 128-key items and 64-row
    q tiles: one short of a tile, one over, three halves, and so on at
    two tiles; MHA at D 128 and GQA g = 4 at D 64."""
    _split_bwd_matches_plain(8, 8 // g, s, d, causal)


@pytest.mark.parametrize("s,sk", [(128, 200), (200, 128), (65, 1000),
                                  (1000, 65)])
def test_split_backward_matches_plain_across_lengths(s, sk):
    """Non-causal S ≠ Sk at g = 4: a ragged key tail in the dQ kernel's
    last K/V tile and the dK/dV kernel's last item, and a ragged q tail
    in both."""
    _split_bwd_matches_plain(8, 2, s, 128, False, sk)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_split_backward_matches_plain_at_the_ring_block(causal):
    """The DP×SP step's blocks of 256 rows: [1024, 256, 128] causal on the
    diagonal (4 ranks × 16 sequences × 16 heads), [768, 256, 128] full on
    the first hop."""
    _split_bwd_matches_plain(1024 if causal else 768,
                             1024 if causal else 768, 256, 128, causal)


def test_split_backward_is_deterministic():
    """Neither kernel sums across blocks: two launches on the same inputs
    give bit-equal dq, dk and dv, at the GQA run's causal shape and a
    ragged non-causal one."""
    from tpu_dra_torch.workloads import flash as tf
    for shape in ((64, 16, 1024, 128, True), (8, 2, 1000, 64, False)):
        args, first = _split_bwd_matches_plain(*shape)
        second = (tf.flash_bwd_dq(*args), *tf.flash_bwd_dkdv(*args))
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), first, second):
            assert torch.equal(a, b), (shape, name)


def test_flash_attention_autograd_on_the_card_matches_plain():
    """The front door through FlashAttentionLse: GQA grads group-summed."""
    from tpu_dra_torch.workloads import flash as tf
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
        for shape in ((2, 8, 300, 128), (2, 2, 300, 128), (2, 2, 300, 128)))
    do = torch.randn((2, 8, 300, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    out = tf.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    fold = lambda t: t.detach().reshape(-1, 300, 128)   # noqa: E731
    want, l2 = tf.flash_attn_fwd_ref(fold(q), fold(k), fold(v))
    _flash_close(fold(out), want, tf.ROW_TOL["out"])
    wants = tf.flash_attn_bwd_ref(fold(q), fold(k), fold(v), fold(out), l2,
                                  fold(do))
    for g, w, name in zip(grads, wants, ("dq", "dk", "dv")):
        # dk/dv are group sums of g = 4 per-head terms: one more rounding
        _flash_close(fold(g), w, 2 * tf.ROW_TOL[name])


def test_flash_wrappers_raise_on_what_the_kernels_do_not_take():
    from tpu_dra_torch.workloads import flash as tf
    dev = card()
    q = torch.zeros((2, 16, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="D 64 or 128"):
        tf.flash_attn_fwd(q, q, q)
    q = torch.zeros((2, 16, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        tf.flash_attn_fwd(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="contiguous"):
        tf.flash_attn_fwd(q, q.transpose(0, 1).contiguous().transpose(0, 1),
                          q)
    with pytest.raises(ValueError, match="on cuda"):
        tf.flash_attn_fwd(q, q.cpu(), q.cpu())
    kv3 = torch.zeros((3, 16, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="not a multiple"):
        tf.flash_attn_fwd(q, kv3, kv3)
    l2 = torch.zeros((2, 16, 1), device=dev)
    with pytest.raises(ValueError, match="fp32"):
        tf.flash_bwd_dq(q, q, q, q, l2.double(), l2, True)
    with pytest.raises(ValueError, match="dout"):
        tf.flash_bwd_dkdv(q, q, q, q[:, :8].contiguous(), l2, l2, False)


# --------------------------------------------------------------------------
# the fused flash backward (workloads/flash.py flash_bwd_fused)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    (8, 8, 300, 128, True, None), (8, 2, 200, 64, True, None),
    (8, 2, 100, 128, False, 300), (4, 4, 2048, 128, True, None),
    (4, 1, 2500, 64, False, None), (8, 2, 1000, 128, False, None),
    (8, 8, 129, 128, True, None), (4, 4, 1000, 128, True, None)],
    ids=["mha-300", "gqa4-d64-200", "cross-100x300", "two-blocks-2048",
         "mqa-three-blocks-2500", "gqa4-full-1000", "causal-129",
         "causal-1000"])
def test_flash_fused_kernel_matches_plain(shape):
    """dq (from the kernel's fp32 sums per KV_BLOCK keys: one to three
    blocks here, the last ragged), and per-q-head dk, dv, against
    flash_bwd_fused_ref; S 129 and 1000 are not multiples of the kernel's
    128-key item."""
    from tpu_dra_torch.workloads import flash as tf
    bh, bhkv, s, d, causal, sk = shape
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(bh * 11 + s + d)
    sk = sk or s

    def draw(n, length):
        return torch.randn((n, length, d), generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v, do = draw(bh, s), draw(bhkv, sk), draw(bhkv, sk), draw(bh, s)
    out, l2 = tf.flash_attn_fwd_ref(q, k, v, causal)
    qs = tf._prescale(q).contiguous()
    dd = (do.float() * out.float()).sum(-1, keepdim=True)
    before = (tf.flash_bwd_fused.launches, tf.flash_bwd_dq.launches,
              tf.flash_bwd_dkdv.launches)
    got = tf.flash_bwd_fused(qs, k, v, do, l2, dd, causal)
    torch.cuda.synchronize()
    assert (tf.flash_bwd_fused.launches, tf.flash_bwd_dq.launches,
            tf.flash_bwd_dkdv.launches) == (before[0] + 1, *before[1:])
    want = tf.flash_bwd_fused_ref(qs, k, v, do, l2, dd, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _flash_close(g, w, tf.ROW_TOL[name])


def test_flash_fused_backward_is_deterministic():
    """Two calls on the same inputs give bit-equal dq, dk and dv: the
    128-key items add their dq sums into each block's accumulator in key
    order, behind flags (no atomics), at a causal shape of two KV_BLOCKs
    and a non-causal GQA one."""
    from tpu_dra_torch.workloads import flash as tf
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    for bh, bhkv, s, causal in ((4, 4, 2048, True), (8, 2, 1000, False)):
        q, k, v, do = (torch.randn((n, s, 128), generator=gen, device=dev)
                       .to(torch.bfloat16) for n in (bh, bhkv, bhkv, bh))
        _, l2 = tf.flash_attn_fwd_ref(q, k, v, causal)
        out = tf.flash_attn_fwd_ref(q, k, v, causal)[0]
        qs = tf._prescale(q).contiguous()
        dd = (do.float() * out.float()).sum(-1, keepdim=True)
        first = tf.flash_bwd_fused(qs, k, v, do, l2, dd, causal)
        second = tf.flash_bwd_fused(qs, k, v, do, l2, dd, causal)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), first, second):
            assert torch.equal(a, b), (bh, s, causal, name)


def test_flash_fused_scratch_stays_under_a_third_of_a_gigabyte():
    """At the training path's [256, 1024, 128] causal the wrapper's scratch
    is one fp32 dQ accumulator and its flags: under 0.3 GB (the per-tile
    slots it replaces took 1.14 GB), as allocated on the card."""
    from tpu_dra_torch.workloads import flash as tf
    dev = card()
    q = torch.zeros((256, 1024, 128), dtype=torch.bfloat16, device=dev)
    l2 = torch.zeros((256, 1024, 1), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tf.flash_bwd_fused(q, q, q, q, l2, l2, True)
    torch.cuda.synchronize()
    outputs = 3 * q.numel() * 2                      # dq, dk, dv
    scratch = torch.cuda.max_memory_allocated() - base - outputs
    # the allocator rounds each block up to 512 bytes
    assert 0 <= scratch - tf.fused_scratch_bytes(256, 1024, 1024, 128) < 512
    assert scratch < 0.3e9, scratch


def test_flash_fused_front_door_on_the_card():
    """``flash_attention(bwd_impl="fused")`` launches the fused kernel and
    neither split kernel, and its GQA gradients match the plain fused
    backward's."""
    from tpu_dra_torch.workloads import flash as tf
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
        for shape in ((2, 8, 300, 128), (2, 2, 300, 128), (2, 2, 300, 128)))
    do = torch.randn((2, 8, 300, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    before = (tf.flash_bwd_fused.launches, tf.flash_bwd_dq.launches,
              tf.flash_bwd_dkdv.launches)
    out = tf.flash_attention(q, k, v, bwd_impl="fused")
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (tf.flash_bwd_fused.launches, tf.flash_bwd_dq.launches,
            tf.flash_bwd_dkdv.launches) == (before[0] + 1, *before[1:])
    fold = lambda t: t.detach().reshape(-1, 300, 128)   # noqa: E731
    _, l2 = tf.flash_attn_fwd_ref(fold(q), fold(k), fold(v))
    wants = tf.flash_attn_bwd_ref(fold(q), fold(k), fold(v), fold(out), l2,
                                  fold(do), bwd_impl="fused")
    for g, w, name in zip(grads, wants, ("dq", "dk", "dv")):
        _flash_close(fold(g), w, 2 * tf.ROW_TOL[name])


def test_flash_fused_wrapper_raises_on_what_the_kernel_does_not_take():
    from tpu_dra_torch.workloads import flash as tf
    dev = card()
    q = torch.zeros((2, 16, 64), dtype=torch.bfloat16, device=dev)
    l2 = torch.zeros((2, 16, 1), device=dev)
    with pytest.raises(ValueError, match="fp32"):
        tf.flash_bwd_fused(q, q, q, q, l2.double(), l2, True)
    with pytest.raises(ValueError, match="D 64 or 128"):
        q96 = torch.zeros((2, 16, 96), dtype=torch.bfloat16, device=dev)
        tf.flash_bwd_fused(q96, q96, q96, q96, l2, l2, True)


# --------------------------------------------------------------------------
# the tiled matmul and the fused RMSNorm-matmul (workloads/matmul.py)
# --------------------------------------------------------------------------

def _mm_close(got, want):
    from tpu_dra_torch.workloads import matmul as tm
    from tpu_dra_torch.workloads.flash import row_rel_err
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tm.ELEM_TOL,
                               atol=tm.ELEM_TOL)
    assert float(row_rel_err(got, want).max()) <= tm.ROW_TOL


@pytest.mark.parametrize("mkn", [(256, 256, 256), (200, 512, 264),
                                 (1000, 64, 72), (128, 40, 8),
                                 (2048, 1024, 640), (1, 256, 256),
                                 (300, 512, 512), (256, 256, 136),
                                 (512, 72, 256)])
def test_matmul_kernel_matches_plain(mkn):
    """Ragged tiles in every dimension: m 1, 200, 300 and 1000 (a lone
    block of a cluster's row-tile pair past M), k 40 and 72 (partial
    64-deep stages), n 264, 136, 72 and 8 (partial 256-wide tiles)."""
    from tpu_dra_torch.workloads import matmul as tm
    m, k, n = mkn
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
    before = tm.matmul.launches
    got = tm.matmul(x, y)
    torch.cuda.synchronize()
    assert tm.matmul.launches == before + 1
    _mm_close(got, tm.matmul_ref(x, y))


@pytest.mark.parametrize("mkn", [(64, 128, 512), (200, 2048, 256),
                                 (768, 1032, 512), (256, 8, 256)])
def test_rmsnorm_matmul_kernel_matches_plain(mkn):
    """The norm prologue over K 8 to 2048 (1032: a ragged last tile), rows
    of mixed scale, a gain away from 1, ragged m."""
    from tpu_dra_torch.workloads import matmul as tm
    m, k, n = mkn
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(m * 3 + k + n)
    scale = torch.rand((m, 1), generator=gen, device=dev) * 8 + 0.01
    x = (torch.randn((m, k), generator=gen, device=dev) * scale).to(
        torch.bfloat16)
    g = 1 + 0.2 * torch.randn((k,), generator=gen, device=dev)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(
        torch.bfloat16)
    before = tm.fused_rmsnorm_matmul.launches
    got = tm.fused_rmsnorm_matmul(x, g, w)
    torch.cuda.synchronize()
    assert tm.fused_rmsnorm_matmul.launches == before + 1
    _mm_close(got, tm.fused_rmsnorm_matmul_ref(x, g, w))


def test_rmsnorm_matmul_kernel_around_the_wgmma_tiles():
    """The RMSNorm-matmul off the matmul's 128 x 256 tiles and 64-deep
    stages (within the reference's tiling contract, so m and n below 256):
    m not a multiple of 128 (a cluster's second row tile partly or wholly
    past M), n not a multiple of 256, K 64 (one stage) and K 1032 (a last
    stage of 8 columns of normed x, zero-filled past K); each called
    twice, bit-equal."""
    from tpu_dra_torch.workloads import matmul as tm
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1032)
    for m, k, n in [(200, 64, 136), (130, 1032, 248), (77, 1032, 200),
                    (256, 64, 256)]:
        scale = torch.rand((m, 1), generator=gen, device=dev) * 8 + 0.01
        x = (torch.randn((m, k), generator=gen, device=dev) * scale).to(
            torch.bfloat16)
        g = 1 + 0.2 * torch.randn((k,), generator=gen, device=dev)
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(
            torch.bfloat16)
        got = tm.fused_rmsnorm_matmul(x, g, w)
        again = tm.fused_rmsnorm_matmul(x, g, w)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (m, k, n)
        _mm_close(got, tm.fused_rmsnorm_matmul_ref(x, g, w))


def test_rmsnorm_matmul_function_on_the_card_matches_the_plain_pair():
    """Gradients through RmsnormMatmul (kernel forward, the reference's
    plain backward with fp32-output products) against autograd through
    the unfused pair of the train trunk, on the card."""
    from tpu_dra_torch.workloads import matmul as tm
    from tpu_dra_torch.workloads.train import _rmsnorm
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn((512, 256), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    g = (1 + 0.1 * torch.randn((256,), generator=gen, device=dev)) \
        .requires_grad_()
    w = (torch.randn((256, 512), generator=gen, device=dev) * 0.0625).to(
        torch.bfloat16).requires_grad_()
    do = torch.randn((512, 512), generator=gen, device=dev).to(
        torch.bfloat16)
    got = torch.autograd.grad(tm.RmsnormMatmul.apply(x, g, w), (x, g, w), do)
    want = torch.autograd.grad(_rmsnorm(x, g) @ w, (x, g, w), do)
    for name, a, b in zip("xgw", got, want):
        assert a.dtype == b.dtype, name
        err = float((a.float() - b.float()).norm() / b.float().norm())
        # bf16 noise of two orders of summation, and the pair's bf16
        # rounding of dNorm where the Function keeps it in fp32
        assert err < 2e-2, (name, err)


def test_matmul_wrappers_raise_on_what_the_kernels_do_not_take():
    from tpu_dra_torch.workloads import matmul as tm
    dev = card()
    x = torch.zeros((128, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        tm.matmul(x.float(), x.T.contiguous().float())
    with pytest.raises(ValueError, match="multiples of 8"):
        tm.matmul(x[:, :36].contiguous(), x[:36, :36].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tm.matmul(x, x.T)
    with pytest.raises(ValueError, match="on cuda"):
        tm.fused_rmsnorm_matmul(x, torch.ones(64), x.T.contiguous().cpu())


# --------------------------------------------------------------------------
# ring kernels: all-gather-matmul, matmul-reduce-scatter, shift
# (workloads/collective_matmul.py)
# --------------------------------------------------------------------------

def _ring_close(got, want):
    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads.flash import row_rel_err
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=cm.ELEM_TOL,
                               atol=cm.ELEM_TOL)
    assert float(row_rel_err(got.flatten(0, -2), want.flatten(0, -2))
                 .max()) <= cm.ROW_TOL


def _ring_operands(gen, G, n, rows, K, N, shared_w=False):
    dev = gen.device
    x = torch.randn((G, n, rows, K), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((1 if shared_w else G, n, K, N), generator=gen,
                     device=dev) * K ** -0.5).to(torch.bfloat16)
    return x, (w.expand(G, -1, -1, -1) if shared_w else w)


# (G, n, m, K, N): n 2, 3, 4 and 8; m even (bidirectional from n 3) and
# odd (unidirectional); K and N not multiples of the tiles; two groups
# sharing one weight (dp 2); then around the wgmma mainloop's tiles (128
# rows, 256 columns, 64-deep K stages): K 72 (a whole stage and 8 of the
# next), N 264 (a second column tile of 8 columns) at odd m, N 512 (wo^T's
# width) over a full K, and two groups sharing a weight at ragged tiles
RING_CASES = [(1, 2, 64, 128, 64), (1, 3, 130, 96, 136), (1, 4, 200, 256, 72),
              (1, 4, 77, 64, 128), (2, 4, 64, 520, 200), (1, 8, 16, 64, 64),
              (2, 2, 33, 40, 16), (1, 4, 301, 72, 264), (1, 4, 256, 2048, 512),
              (2, 4, 130, 136, 520)]


@pytest.mark.parametrize("case", RING_CASES, ids=str)
def test_all_gather_matmul_kernel_matches_plain(case):
    from tpu_dra_torch.workloads import collective_matmul as cm
    G, n, m, K, N = case
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(sum(case))
    x, w = _ring_operands(gen, G, n, m, K, N, shared_w=G > 1)
    before = cm.all_gather_matmul.launches
    y, a = cm.all_gather_matmul(x, w)
    torch.cuda.synchronize()
    assert cm.all_gather_matmul.launches == before + 1
    want_y, want_a = cm.all_gather_matmul_ref(x, w)
    assert torch.equal(a, want_a)
    _ring_close(y, want_y)


@pytest.mark.parametrize("n,m", [(3, 64), (4, 130), (8, 32)])
def test_bidirectional_and_unidirectional_rings_agree_bit_for_bit(n, m):
    """The same even-m inputs through both schedules (the C entry takes
    the direction as a flag), one launch each on zeroed flag words: every
    row's product is the same sum."""
    from tpu_dra_torch.kernels.build import library
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(n * m)
    x, w = _ring_operands(gen, 1, n, m, 64, 96)
    lib = library("ring")
    stream = torch.cuda.current_stream().cuda_stream
    flags = torch.zeros(n * lib.tpu_dra_ring_flag_words(n), dtype=torch.int32,
                        device=dev)
    outs = []
    for epoch, bidir in enumerate((1, 0), 1):
        y = torch.empty((1, n, n * m, 96), dtype=torch.bfloat16, device=dev)
        a = torch.empty((1, n, n, m, 64), dtype=torch.bfloat16, device=dev)
        assert lib.tpu_dra_ring_ag_matmul(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), a.data_ptr(),
            flags.data_ptr(), 1, n, m, 64, 96, m * 64, n * m * 64,
            w.stride(1), 0, bidir, epoch, stream) == 0
        outs.append((y, a))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("case", RING_CASES, ids=str)
def test_matmul_reduce_scatter_kernel_matches_plain(case):
    from tpu_dra_torch.workloads import collective_matmul as cm
    G, n, m, K, N = case
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(sum(case) + 1)
    x, w = _ring_operands(gen, G, n, n * m, K, N, shared_w=G > 1)
    before = cm.matmul_reduce_scatter.launches
    y = cm.matmul_reduce_scatter(x, w)
    torch.cuda.synchronize()
    assert cm.matmul_reduce_scatter.launches == before + 1
    _ring_close(y, cm.matmul_reduce_scatter_ref(x, w))


@pytest.mark.parametrize("m,K,N", [(100, 72, 264), (256, 512, 512)])
def test_ring_matmul_kernels_at_one_rank(m, K, N):
    """The C entries at n 1 (the wrappers take the plain product there
    and launch nothing): the gather's one step is x·w with a = x, the
    reduce-scatter's one step rounds x·w into y (its comm one unused
    slot); nothing waits on the flags."""
    from tpu_dra_torch.kernels.build import library
    from tpu_dra_torch.workloads import collective_matmul as cm
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(m + K + N)
    x, w = _ring_operands(gen, 1, 1, m, K, N)
    lib = library("ring")
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty((1, 1, m, N), dtype=torch.bfloat16, device=dev)
    a = torch.empty((1, 1, 1, m, K), dtype=torch.bfloat16, device=dev)
    flags = torch.zeros(lib.tpu_dra_ring_flag_words(1), dtype=torch.int32,
                        device=dev)
    assert lib.tpu_dra_ring_ag_matmul(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), a.data_ptr(),
        flags.data_ptr(), 1, 1, m, K, N, m * K, m * K, K * N, 0, 0, 1,
        stream) == 0
    torch.cuda.synchronize()
    want_y, want_a = cm.all_gather_matmul_ref(x, w)
    assert torch.equal(a, want_a)
    _ring_close(y, want_y)
    comm = torch.empty((1, 1, 1, m, N), dtype=torch.float32, device=dev)
    y2 = torch.empty_like(y)
    assert lib.tpu_dra_ring_matmul_rs(
        x.data_ptr(), w.data_ptr(), comm.data_ptr(), y2.data_ptr(),
        flags.data_ptr(), 1, 1, m, K, N, m * K, m * K, K * N, 0, 2,
        stream) == 0
    torch.cuda.synchronize()
    _ring_close(y2, cm.matmul_reduce_scatter_ref(x, w))


def test_ring_calls_back_to_back_each_match_plain():
    """30 gathers and 30 reduce-scatters on the virtual ring, enqueued
    with no host synchronize between them, each on fresh inputs and on
    the ring's one flag buffer (a call's epoch its own): every output is
    held to its plain version afterwards, so a flag or a slot that a call
    took from the one before it shows."""
    from tpu_dra_torch.workloads import collective_matmul as cm
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    G, n, m, K, N = 2, 4, 130, 136, 264
    runs = []
    for i in range(30):
        x, w = _ring_operands(gen, G, n, m - (i % 2), K, N, shared_w=True)
        runs.append((x, w, cm.all_gather_matmul(x, w)))
        xr, wr = _ring_operands(gen, G, n, n * m, K, N, shared_w=True)
        runs.append((xr, wr, cm.matmul_reduce_scatter(xr, wr)))
    torch.cuda.synchronize()
    for x, w, got in runs:
        if isinstance(got, tuple):
            want_y, want_a = cm.all_gather_matmul_ref(x, w)
            assert torch.equal(got[1], want_a)
            _ring_close(got[0], want_y)
        else:
            _ring_close(got, cm.matmul_reduce_scatter_ref(x, w))


SPIN_CHILD = """
import os, sys, time
import torch
import torch.distributed as dist
from tpu_dra_torch.workloads import collective_matmul as cm
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + sys.argv[2],
                        world_size=2, rank=rank)
torch.cuda.set_device(0)
cm.SPIN_TIMEOUT_S = 2.0
ring = cm.ProcessRing()
x = torch.ones((4, 64), dtype=torch.bfloat16, device="cuda")
w = torch.ones((64, 64), dtype=torch.bfloat16, device="cuda")
ring._buffers(x.device, 2 * 4 * 64 * 2)     # both grow the buffers together
if rank == 0:
    ring.all_gather_matmul(x, w)            # rank 1 never calls
    t0 = time.monotonic()
    try:
        cm.ring_synchronize()
    except cm.RingTimeout as err:
        print("RAISED", round(time.monotonic() - t0, 1), err, flush=True)
    else:
        print("NO ERROR", flush=True)
    os._exit(0)
time.sleep(60)
os._exit(0)
"""


def test_a_neighbour_that_never_calls_raises_rather_than_hangs(tmp_path):
    """Two processes on a process ring, the second of which never calls:
    the first's gather kernel waits for it (at the neighbour barrier, or
    for the first slot it would forward), runs past the spin bound (2 s
    here), traps, and ``ring_synchronize`` raises ``RingTimeout`` naming
    the kernel, the ring, the rank, the step and the call, within
    seconds.  The processes are children, so the trapped context does not
    poison this one."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from tpu_dra_torch.kernels.build import library
    card()
    library("ring")                 # built once, before the children load it
    repo = str(Path(__file__).resolve().parent.parent)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    script = tmp_path / "spin_child.py"
    script.write_text(SPIN_CHILD)
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=repo, env=env)
             for r in range(2)]
    try:
        out, err = procs[0].communicate(timeout=120)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    line = next((ln for ln in out.splitlines() if ln.startswith(("RAISED",
                                                                 "NO "))),
                f"no line: {err[-2000:]}")
    assert line.startswith("RAISED"), line
    assert float(line.split()[1]) < 30, line
    assert "all_gather_matmul: rank 0 of the process ring" in line, line
    assert "ring step" in line and "(call 2 on the ring)" in line, line


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 16, 16, 64, 128), torch.bfloat16),   # vector copies
    ((1, 3, 5, 7), torch.float32),
    ((2, 2, 33), torch.bfloat16)],               # 66-byte blocks: bytes
    ids=["kv-blocks", "fp32-odd", "ragged-bytes"])
def test_ring_shift_kernel_is_the_plain_shift(shape, dtype, reverse):
    from tpu_dra_torch.workloads import collective_matmul as cm
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    before = cm.ring_shift.launches
    y = cm.ring_shift(x, reverse)
    torch.cuda.synchronize()
    assert cm.ring_shift.launches == before + 1
    assert torch.equal(y, cm.ring_shift_ref(x, reverse))


def test_ring_vjps_on_the_card_match_the_plain_vjps():
    """AllGatherMatmul and MatmulReduceScatter (each backward the other
    kernel) and RingShift against autograd through the plain versions."""
    from tpu_dra_torch.workloads import collective_matmul as cm
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    x, w = _ring_operands(gen, 2, 4, 64, 128, 96, shared_w=True)
    w0 = w[:1].detach().clone()
    for fn, ref, rows in ((cm.AllGatherMatmul, cm.all_gather_matmul_ref, 64),
                          (cm.MatmulReduceScatter,
                           cm.matmul_reduce_scatter_ref, 256)):
        xi = torch.randn((2, 4, rows, 128), generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_()
        wi = w0.clone().requires_grad_()
        out = fn.apply(xi, wi.expand(2, -1, -1, -1))
        g = torch.randn(out.shape, generator=gen, device=dev).to(
            torch.bfloat16)
        got = torch.autograd.grad(out, (xi, wi), g)
        xr, wr = xi.detach().requires_grad_(), w0.clone().requires_grad_()
        plain = ref(xr, wr.expand(2, -1, -1, -1))
        plain = plain[0] if isinstance(plain, tuple) else plain
        want = torch.autograd.grad(plain, (xr, wr), g)
        for a, b in zip(got, want):
            err = float((a.float() - b.float()).norm() / b.float().norm())
            assert err < 1e-2, (fn.__name__, err)
    xs = torch.randn((2, 4, 8, 64), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    g = torch.randn_like(xs)
    (d,) = torch.autograd.grad(cm.RingShift.apply(xs, False), xs, g)
    assert torch.equal(d, cm.ring_shift_ref(g, True))


def test_ring_wrappers_raise_on_what_the_kernels_do_not_take():
    from tpu_dra_torch.workloads import collective_matmul as cm
    dev = card()
    x = torch.zeros((1, 4, 64, 36), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((1, 4, 36, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        cm.all_gather_matmul(x, w)
    with pytest.raises(ValueError, match="bf16"):
        cm.matmul_reduce_scatter(x[..., :32].float(), w[:, :, :32].float())
    with pytest.raises(ValueError, match="contiguous"):
        cm.all_gather_matmul(x[..., :32], w[:, :, :32].contiguous())


# the quantized weight forms (quant.py): library products on the card,
# held to the plain versions on the CPU (chip_smoke.py phase 15 holds them
# at the serving model's shapes)

@pytest.mark.parametrize("rows", [1, 16, 17, 40])
@pytest.mark.parametrize("layout", ["column", "row"])
def test_int8_product_on_the_card_is_exact(rows, layout):
    """torch._int_mm takes the product at any row count (rows up to 16
    padded) and either weight layout, bit-equal to the plain version."""
    from tpu_dra_torch.workloads.quant import (column_major, int8_product,
                                               int8_product_ref)
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(rows)
    xq = torch.randint(-127, 128, (rows, 256), generator=gen, device=dev,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (256, 96), generator=gen, device=dev,
                       dtype=torch.int8)
    if layout == "column":
        wq = column_major(wq)
    got = int8_product(xq, wq)
    assert got.dtype == torch.int32 and got.shape == (rows, 96)
    assert torch.equal(got, int8_product_ref(xq, wq))


def test_int8_matmul_and_its_backward_on_the_card():
    from tpu_dra_torch.workloads.quant import int8_matmul, quantize_int8
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    q = quantize_int8(torch.randn((128, 64), generator=gen, device=dev))
    x = torch.randn((2, 5, 128), generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_()
    y = int8_matmul(x, q["q8"], q["s"])
    xc = x.detach().cpu().requires_grad_()
    yc = int8_matmul(xc, q["q8"].cpu(), q["s"].cpu())
    assert torch.equal(y.detach().cpu(), yc.detach())
    g = torch.randn(y.shape, generator=gen, device=dev)
    (y * g).sum().backward()
    (yc * g.cpu()).sum().backward()
    torch.testing.assert_close(x.grad.cpu().float(), xc.grad.float(),
                               rtol=2 ** -7, atol=1e-3)


def test_int8_product_refuses_what_int_mm_does_not_take():
    from tpu_dra_torch.workloads.quant import int8_product
    dev = card()
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_product(torch.zeros((32, 12), dtype=torch.int8, device=dev),
                     torch.zeros((12, 16), dtype=torch.int8, device=dev))


@pytest.mark.parametrize("group", [32, 128])
def test_int4_matmul_on_the_card_within_fp32_sums(group):
    from tpu_dra_torch.workloads.quant import int4_matmul, quantize_int4
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(group)
    q = quantize_int4(torch.randn((256, 96), generator=gen, device=dev),
                      group)
    x = torch.randn((3, 7, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    got = int4_matmul(x, q["q4"], q["s4"]).cpu()
    want = int4_matmul(x.cpu(), q["q4"].cpu(), q["s4"].cpu())
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_slab_decode_on_the_card_follows_the_cpu():
    """The slab decoder over int8 weights and an int8 cache on a small
    model: the card's prefill and decode-step logits within bf16
    tolerance of the CPU's (plain versions), and its decode runs."""
    from tpu_dra_torch.workloads.continuous import _to_device
    from tpu_dra_torch.workloads.decode import (_token_logits, greedy_decode,
                                                init_kv_cache, prefill)
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    dev = card()
    cfg = ModelConfig(vocab=256, d_model=128, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=256, max_seq=64, pos_emb="rope")
    gen = torch.Generator().manual_seed(0)
    params = quantize_params_int8(init_params(cfg, gen))
    prompt = torch.randint(0, 256, (3, 9), generator=gen)
    logits = {}
    for where in ("cpu", dev):
        p = _to_device(params, where)
        cache = init_kv_cache(cfg, 3, 16, "int8", device=where)
        cache, first = prefill(cfg, p, cache, prompt.to(where))
        step, cache = _token_logits(
            cfg, p, cache, 9, torch.tensor([5, 6, 7], dtype=torch.int32,
                                           device=where))
        logits[str(where)] = (first.cpu(), step.cpu())
        toks = greedy_decode(cfg, p, prompt.to(where), steps=6,
                             cache_dtype="int8")
        assert toks.shape == (3, 6) and toks.device.type == \
            torch.device(where).type
    for got, want in zip(logits[str(dev)], logits["cpu"]):
        torch.testing.assert_close(got, want, rtol=2 ** -5, atol=2 ** -4)


def _corpus(path, n=20000, vocab=256):
    import numpy as np

    from tpu_dra_torch.workloads.data import TokenDataset
    r = np.random.default_rng(0)
    toks = np.resize(r.integers(0, vocab, 17), n)
    TokenDataset.write(str(path), toks)
    return str(path)


def test_resume_on_the_card_is_bit_exact(tmp_path):
    """fit with flash on the card: 4 steps saving at 2 and 4; a resume
    from step 2 (step 4's marker removed) gives the uninterrupted run's
    losses and step-4 parameters and moments bit for bit."""
    from tpu_dra_torch.workloads.checkpointing import (_COMMIT_MARKER,
                                                       restore_train_state)
    from tpu_dra_torch.workloads.fit import fit
    from tpu_dra_torch.workloads.train import ModelConfig, tree_leaves
    card()
    cfg = ModelConfig(vocab=256, d_model=256, n_heads=2, n_layers=2,
                      d_ff=512, max_seq=128)
    path, ck = _corpus(tmp_path / "t.bin"), tmp_path / "ck"
    kw = dict(batch=4, lr=1e-3, attn_impl="flash", log_every=1,
              checkpoint_dir=str(ck), checkpoint_every=2,
              log_fn=lambda s: None)
    full = fit(cfg, path, steps=4, **kw)
    want = restore_train_state(str(ck), device="cpu")
    (ck / "4" / _COMMIT_MARKER).unlink()
    res = fit(cfg, path, steps=2, resume=True, **kw)
    got = restore_train_state(str(ck), device="cpu")
    assert res.losses == full.losses[2:]

    def leaves(st):
        o = st["extra"]["opt_state"]
        return tree_leaves(st["params"]) + tree_leaves(o["mu"]) + \
            tree_leaves(o["nu"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(want),
                                                 leaves(got)))


def test_moe_step_with_flash_matches_dense_on_the_card():
    """One MoE training step's loss and gradients with the flash kernels
    against dense attention, the flash pass's expert choices replayed
    (chip_smoke.py's STEP tolerances), and the flash forward launched
    twice a layer (the block's remat)."""
    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.moe import (MoEConfig, PinnedChoices,
                                             init_moe_params, moe_loss_fn)
    from tpu_dra_torch.workloads.train import tree_leaves, value_and_grad
    dev = card()
    cfg = MoEConfig(vocab=256, d_model=256, n_heads=2, n_layers=2, d_ff=512,
                    max_seq=128, n_experts=4, router_top_k=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_moe_params(cfg, gen)
    toks = torch.randint(0, 256, (4, 129), generator=gen, device=dev)
    F.flash_attn_fwd.launches = 0
    with PinnedChoices() as pin:
        lf, gf = value_and_grad(
            lambda p, t: moe_loss_fn(cfg, p, t, "flash"), params, toks)
        assert F.flash_attn_fwd.launches == 2 * cfg.n_layers
        pin.replay()
        ld, gd = value_and_grad(lambda p, t: moe_loss_fn(cfg, p, t),
                                params, toks)
    assert abs(float(lf) - float(ld)) <= 5e-3
    for a, b in zip(tree_leaves(gf), tree_leaves(gd)):
        assert float((a - b).norm() / b.norm()) <= 3e-2


def test_weights_cache_hit_serves_bit_identically_on_the_card(tmp_path):
    """A serving tree quantized, saved to a weights cache and restored on
    the card serves the same greedy tokens as the tree it was saved from
    (``q8`` column-major again after the restore)."""
    from tpu_dra_torch.workloads.checkpointing import (restore_serving_state,
                                                       save_serving_state)
    from tpu_dra_torch.workloads.decode import greedy_decode
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    dev = card()
    cfg = ModelConfig(vocab=256, d_model=128, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=256, max_seq=64, pos_emb="rope")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    miss = quantize_params_int8(init_params(cfg, gen))
    save_serving_state(str(tmp_path / "wc"), miss, meta={"form": "int8"})
    hit = restore_serving_state(str(tmp_path / "wc"))
    assert hit["blocks"]["wqkv"]["q8"].device.type == "cuda"
    assert hit["blocks"]["wqkv"]["q8"].transpose(-1, -2).is_contiguous()
    prompt = torch.randint(0, 256, (3, 9), generator=gen, device=dev)
    assert torch.equal(greedy_decode(cfg, hit, prompt, steps=8),
                       greedy_decode(cfg, miss, prompt, steps=8))


def _serving_model(dev, seed=0):
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(vocab=256, d_model=128, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=256, max_seq=64, pos_emb="rope")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return cfg, quantize_params_int8(init_params(cfg, gen))


def test_pool_generate_on_the_card_equals_decode_of_the_padded_batch():
    """The bucketed pool behind /generate without --continuous: three
    ragged rows padded to the batch bucket 4 and the prompt bucket 16,
    bit-equal to ``decode`` of that padded batch on the card."""
    import json
    import urllib.request

    from tpu_dra_torch.workloads.decode import decode
    from tpu_dra_torch.workloads.serve import serve
    dev = card()
    cfg, params = _serving_model(dev)
    rows = [[5, 17, 3], list(range(40, 53)), [200, 9]]
    srv = serve(cfg, params, port=0, continuous=False)
    try:
        host, port = srv.server_address[:2]
        req = urllib.request.Request(
            f"http://{host}:{port}/generate",
            data=json.dumps({"tokens": rows, "steps": 12}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            got = json.loads(r.read())["tokens"]
    finally:
        srv.shutdown()
    prompts = torch.zeros((4, 16), dtype=torch.int32)
    for i, r in enumerate(rows):
        prompts[i, :len(r)] = torch.tensor(r)
    want = decode(cfg, params, prompts.to(dev), steps=12,
                  lengths=[3, 13, 2, 1])
    assert got == want[:3].tolist()


def test_beam_decode_on_the_card_follows_the_cpu():
    """beam_decode on the card against its CPU run (the plain paths), the
    same int8 tree: the same hypotheses, scores within 0.05 (a sum of
    bf16-path log-probabilities, tests/test_torch_beam.py's SCORE_TOL),
    in the same order up to swaps of near-ties."""
    from tpu_dra_torch.workloads.continuous import _to_device
    from tpu_dra_torch.workloads.decode import beam_decode
    dev = card()
    cfg, params = _serving_model(dev, seed=2)
    prompt = torch.randint(0, 256, (2, 7), generator=torch.Generator()
                           .manual_seed(3))
    runs = {}
    for where in ("cpu", dev):
        hist, scores = beam_decode(cfg, _to_device(params, where),
                                   prompt.to(where), steps=8, beams=4)
        runs[str(where)] = (hist.cpu(), scores.cpu())
    (ch, cs), (gh, gs) = runs["cpu"], runs[str(dev)]
    for b in range(2):
        ref = {tuple(h.tolist()): float(s) for h, s in zip(ch[b], cs[b])}
        for w, h in enumerate(gh[b].tolist()):
            assert tuple(h) in ref, (h, list(ref))
            assert abs(float(gs[b, w]) - ref[tuple(h)]) <= 0.05
            if tuple(h) != tuple(ch[b, w].tolist()):
                assert abs(ref[tuple(h)] - float(cs[b, w])) <= 0.1
        assert bool((gs[b, 1:] <= gs[b, :-1]).all())


def test_device_trace_capture_holds_cuda_kernel_events():
    """/debug/jax-trace's capture on the card, taken while another thread
    launches the paged attention kernel: CUDA kernel events in the Chrome
    trace, among them the kernel's."""
    import io
    import json
    import tarfile
    import threading

    from tpu_dra_torch.workloads.serve import capture_device_trace
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    lengths = torch.full((8,), 200, dtype=torch.int32, device=dev)
    q = torch.randn((8, 8, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((2, 40, 64, 128), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    table = torch.arange(32, dtype=torch.int32, device=dev).reshape(8, 4)
    stop = threading.Event()

    def launch():
        while not stop.is_set():
            tpk.paged_attention(q, k, v, table, lengths)
            torch.cuda.synchronize(dev)
    t = threading.Thread(target=launch)
    t.start()
    try:
        body, counts = capture_device_trace(0.5, dev)
    finally:
        stop.set()
        t.join(60)
    assert not t.is_alive()
    assert counts["kernels"] > 0
    with tarfile.open(fileobj=io.BytesIO(body), mode="r:gz") as tar:
        events = json.load(tar.extractfile("jax-trace/trace.json"))[
            "traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert len(names) == counts["kernels"]
    assert any("paged_span_kernel" in n for n in names), names[:10]


# the trunk's remat at a width the flash and matmul kernels take: head dim
# 128, [4, 129] windows (m = 512 trunk rows, admitted by the RMSNorm-
# matmul's rule; the sequence splits over a 2-way tp ring)
REMAT_CFG = dict(vocab=512, d_model=256, n_heads=2, n_layers=2, d_ff=1024,
                 max_seq=128)
REMAT_IMPLS = ("flash", "fused-norm", "fused-collective")


def _remat_step(impl: str, dev):
    """One training step of ``impl``'s trunk on the card: ``(loss,
    grads)`` (``grads_fn``; for the fused-collective trunk the SGD update
    at lr 1 of the DP×TP step, p − p'), and the kernels' counters."""
    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads import flash as tf
    from tpu_dra_torch.workloads import matmul as tm
    from tpu_dra_torch.workloads import train as tt
    from tpu_dra_torch.workloads.mesh import Mesh
    cfg = tt.ModelConfig(**REMAT_CFG)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    params = tt.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab, (4, cfg.max_seq + 1), generator=gen,
                         device=dev)
    counters = (tf.flash_attn_fwd, tf.flash_bwd_dq, tf.flash_bwd_dkdv,
                tm.fused_rmsnorm_matmul, cm.all_gather_matmul,
                cm.matmul_reduce_scatter)
    before = [c.launches for c in counters]
    if impl == "fused-collective":
        step, _, _ = tt.make_sharded_train_step(
            cfg, Mesh({"dp": 1, "tp": 2}, device=dev), lr=1.0,
            attn_impl="flash", matmul_impl="fused_collective")
        new, loss = step(params, toks)
        grads = [p - q for p, q in zip(tt.tree_leaves(params),
                                       tt.tree_leaves(new))]
    else:
        loss, g = tt.grads_fn(cfg, params, toks, attn_impl="flash",
                              norm_impl="fused" if impl == "fused-norm"
                              else "dense")
        grads = tt.tree_leaves(g)
    torch.cuda.synchronize(dev)
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",
             "rmsnorm_matmul", "all_gather_matmul", "matmul_reduce_scatter")
    return loss, grads, {n: c.launches - b
                         for n, c, b in zip(names, counters, before)}


@pytest.mark.parametrize("impl", REMAT_IMPLS)
def test_remat_step_is_bit_equal_to_the_step_without_it(impl, monkeypatch):
    """The trunk's remat changes no bit of a step on the card: its loss
    and every gradient leaf equal the same step's with ``train.remat``
    monkeypatched to a plain call."""
    from tpu_dra_torch.workloads import train as tt
    dev = card()
    loss, grads, _ = _remat_step(impl, dev)
    monkeypatch.setattr(tt, "remat", lambda fn, *args: fn(*args))
    loss0, grads0, _ = _remat_step(impl, dev)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


@pytest.mark.parametrize("impl", REMAT_IMPLS)
def test_remat_step_launch_counts(impl):
    """Under the remat a step launches the flash forward 2·L times (the
    backward recomputes it), each flash backward kernel L times, the
    RMSNorm-matmul 2·L times (its outputs kept: once a sublayer) and each
    ring matmul 4·L·n times (4·L calls over n = 2 ranks: none again)."""
    dev = card()
    L = REMAT_CFG["n_layers"]
    _, _, got = _remat_step(impl, dev)
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkdv": L,
            "rmsnorm_matmul": 2 * L if impl == "fused-norm" else 0,
            "all_gather_matmul": 8 * L if impl == "fused-collective" else 0,
            "matmul_reduce_scatter": 8 * L if impl == "fused-collective"
            else 0}
    assert got == want


@pytest.mark.parametrize("hkv", [4, 1], ids=["mha", "gqa"])
@pytest.mark.parametrize("axes", [{"sp": 4}, {"dp": 2, "sp": 2}],
                         ids=["sp4", "dp2xsp2"])
def test_zigzag_flash_engine_matches_its_fp32_engine_on_the_card(axes, hkv):
    """The zigzag flash engine (the flash kernels per chunk, lse merges)
    against the fp32 engine on the same zigzag-ordered bf16 inputs: the
    outputs within flash.ELEM_TOL elementwise, the gradients of q, k and
    v within 3% relative L2 (the ring step's tolerance, which
    chip_smoke.py phase 23a holds them to: elementwise, a GQA group's
    dk/dv sums four heads' bf16 partials, and 3 of 262144 elements
    reached 1.75 ELEM_TOL on an H100), and the forward kernel launched
    3n times a call."""
    from tpu_dra_torch.workloads import flash as tf
    from tpu_dra_torch.workloads import ring_attention as tra
    from tpu_dra_torch.workloads.mesh import Mesh
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    B, H, S, D = 2, 4, 1024, 128
    q = torch.randn((B, H, S, D), generator=gen, device=dev)
    k, v = (torch.randn((B, hkv, S, D), generator=gen, device=dev)
            for _ in range(2))
    cot = torch.randn((B, H, S, D), generator=gen, device=dev).to(
        torch.bfloat16)
    mesh = Mesh(axes, device=dev)
    outs = {}
    for impl in ("xla", "flash"):
        ins = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v)]
        before = tf.flash_attn_fwd.launches
        out = tra.make_zigzag_ring_attention(mesh, impl=impl)(*ins)
        grads = torch.autograd.grad(out, ins, cot)
        outs[impl] = (out, *grads)
        if impl == "flash":
            assert (tf.flash_attn_fwd.launches - before
                    == 3 * axes["sp"])
    tol = tf.ELEM_TOL
    torch.testing.assert_close(outs["flash"][0].float(),
                               outs["xla"][0].float(), rtol=tol, atol=tol)
    for got, want in zip(outs["flash"][1:], outs["xla"][1:]):
        rel = (got.float() - want.float()).norm() / want.float().norm()
        assert torch.isfinite(got.float()).all() and float(rel) <= 3e-2


def test_zero1_is_bit_equal_to_replicated_moments_on_the_card():
    """make_optax_train_step on Mesh({"dp": 2, "tp": 2}), flash attention,
    3 steps with ZeRO-1 and 3 without: losses, parameters and moments
    bit-equal on the card."""
    from tpu_dra_torch.workloads import train as tt
    from tpu_dra_torch.workloads.mesh import Mesh
    dev = card()
    cfg = tt.ModelConfig(vocab=512, d_model=256, n_heads=2, n_layers=2,
                         d_ff=512, max_seq=256)
    mesh = Mesh({"dp": 2, "tp": 2}, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    tokens = torch.randint(0, 512, (4, 257), generator=gen, device=dev,
                           dtype=torch.int32)
    runs = []
    for zero1 in (False, True):
        gen.manual_seed(0)
        params = tt.init_params(cfg, gen)
        step, init_opt, _, _ = tt.make_optax_train_step(
            cfg, mesh, attn_impl="flash", zero1=zero1)
        opt = init_opt(params)
        losses = []
        for _ in range(3):
            params, opt, loss = step(params, opt, tokens)
            losses.append(float(loss))
        runs.append((losses, params, opt.to_dict()))
    (la, pa, oa), (lb, pb, ob) = runs
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(tt.tree_leaves(pa),
                                                 tt.tree_leaves(pb)))
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(
            tt.tree_leaves(oa[key]), tt.tree_leaves(ob[key])))


def test_process_ring_on_the_card_is_the_virtual_ring_byte_for_byte(
        tmp_path):
    """Two processes on the card (one gloo group; NCCL refuses two ranks
    on one card) run the ring kernels across processes through each
    other's IPC-mapped buffers (tests/torch_process_child.py, started by
    ``launcher.run_local_group``): every rank's gather (odd and even m),
    gathered operand, reduce-scatter, shift both ways and each VJP is
    byte-equal to its rank's slice of the virtual ring's kernels on the
    same global inputs, with one launch a call, counted per process."""
    import os
    import sys
    from pathlib import Path

    from torch_process_child import AG_CASES, ring_inputs

    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads.launcher import run_local_group
    from tpu_dra_torch.kernels.build import library
    dev = card()
    library("ring")                 # built once, before the ranks load it
    child = Path(__file__).resolve().parent / "torch_process_child.py"
    repo = str(child.parent.parent)
    n = 2
    run_local_group([sys.executable, str(child), "ring", str(tmp_path),
                     "cuda"], n, timeout=300, cwd=repo,
                    env=dict(os.environ, PYTHONPATH=repo))
    g = {k: v[None].to(dev) for k, v in ring_inputs(n).items()}

    def vjp(fn, args, cot):
        args = [a.clone().requires_grad_() for a in args]
        return torch.autograd.grad(fn(*args), args, cot)
    want = {}
    for name in AG_CASES:
        x, w = g[f"ag_{name}_x"], g[f"ag_{name}_w"]
        want[f"ag_{name}_y"], want[f"ag_{name}_a"] = cm.all_gather_matmul(
            x, w)
        want[f"ag_{name}_y_fn"] = want[f"ag_{name}_y"]
        want[f"ag_{name}_dx"], want[f"ag_{name}_dw"] = vjp(
            cm.AllGatherMatmul.apply, (x, w), g[f"ag_{name}_cot"])
    want["rs_y"] = cm.matmul_reduce_scatter(g["rs_x"], g["rs_w"])
    want["rs_dx"], want["rs_dw"] = vjp(cm.MatmulReduceScatter.apply,
                                       (g["rs_x"], g["rs_w"]), g["rs_cot"])
    for reverse, tag in ((False, "right"), (True, "left")):
        want[f"shift_{tag}"] = cm.ring_shift(g["shift_x"], reverse)
        want[f"shift_{tag}_plain"] = want[f"shift_{tag}"]
        (want[f"shift_{tag}_dx"],) = vjp(
            lambda t: cm.RingShift.apply(t, reverse), (g["shift_x"].float(),),
            g["shift_cot"].float())
    torch.cuda.synchronize()
    import numpy as np
    for r in range(n):
        with np.load(tmp_path / f"rank{r}.npz") as data:
            got = {k: data[k] for k in data.files}
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v[0, r].float().cpu().numpy(),
                                          err_msg=k)
        # 5 gathers (2 calls a case, and the reduce-scatter's VJP), 4
        # reduce-scatters, 6 shifts: one launch a call
        assert got["launches"].tolist() == [5, 4, 6]


def test_process_dp_tp_step_on_the_card_matches_the_cpu(tmp_path):
    """Two processes on the card (one gloo group) take one
    ``make_sharded_train_step(matmul_impl="fused_collective",
    attn_impl="flash")`` step at lr 1 on ``ProcessMesh({"dp": 1, "tp":
    2})`` (tests/torch_process_child.py's ``tp`` mode), a 2-layer model
    of head dim 128: the loss within 5e-3 and each leaf's update within
    3% relative L2 of the same step in two processes on the CPU, with one
    launch of each ring kernel a call (4·L calls of each) in every
    process."""
    import json
    import os
    import sys
    from pathlib import Path

    import numpy as np

    from tpu_dra_torch.convert import save_npz
    from tpu_dra_torch.kernels.build import build_all
    from tpu_dra_torch.workloads import train as tt
    from tpu_dra_torch.workloads.launcher import run_local_group
    card()
    build_all()                      # built once, before the ranks load them
    child = Path(__file__).resolve().parent / "torch_process_child.py"
    repo = str(child.parent.parent)
    cfg = dict(vocab=256, d_model=256, n_heads=2, n_layers=2, d_ff=512,
               max_seq=64)
    gen = torch.Generator().manual_seed(0)
    save_npz(tmp_path / "p.npz", tt.init_params(tt.ModelConfig(**cfg), gen))
    np.savez(tmp_path / "t.npz", tokens=np.random.default_rng(0).integers(
        0, 256, (4, 65)).astype(np.int32))
    (tmp_path / "cases.json").write_text(json.dumps([{
        "name": "fc", "cfg": cfg, "params": "p.npz", "tokens": "t.npz",
        "impl": "fused_collective", "attn": "flash", "accum": 1}]))
    runs = {}
    for device in ("cpu", "cuda"):
        d = tmp_path / device
        d.mkdir()
        for f in ("p.npz", "t.npz", "cases.json"):
            (d / f).symlink_to(tmp_path / f)
        run_local_group([sys.executable, str(child), "tp", str(d),
                         json.dumps({"dp": 1, "tp": 2}), device], 2,
                        timeout=300, cwd=repo,
                        env=dict(os.environ, PYTHONPATH=repo))
        runs[device] = []
        for r in range(2):
            with np.load(d / f"rank{r}.npz") as data:
                runs[device].append(({k: data[k] for k in data.files},
                                     json.loads((d / f"rank{r}.json")
                                                .read_text())))
    with np.load(tmp_path / "p.npz") as data:
        p0 = {k: data[k].astype(np.float32) for k in data.files}
    want, _ = runs["cpu"][0]
    L = cfg["n_layers"]
    for got, info in runs["cuda"]:
        assert abs(float(got["fc_loss"]) - float(want["fc_loss"])) < 5e-3
        for leaf, w0 in p0.items():
            gw, gg = w0 - want[f"fc/{leaf}"], w0 - got[f"fc/{leaf}"]
            rel = np.linalg.norm(gg - gw) / np.linalg.norm(gw)
            assert rel < 3e-2, (leaf, rel)
        assert info["calls"]["fc"] == [4 * L, 4 * L]
        assert info["launches"]["fc"] == [4 * L, 4 * L]


def test_process_zero1_optax_step_on_the_card_matches_the_cpu(tmp_path):
    """Two processes on the card (one gloo group) take 3 ZeRO-1 AdamW
    steps (``make_optax_train_step(zero1=True, attn_impl="flash")``) on
    ``ProcessMesh({"dp": 2, "tp": 1})`` (tests/torch_process_child.py's
    ``optax`` mode), a 2-layer model of head dim 128: the losses within
    5e-3 every step and each leaf's first moment after step 1 within 3%
    relative L2 of the same steps in two processes on the CPU, with the
    moment bytes a process holds half the replicated layout's."""
    import json
    import os
    import sys
    from pathlib import Path

    import numpy as np

    from tpu_dra_torch.convert import save_npz
    from tpu_dra_torch.kernels.build import build_all
    from tpu_dra_torch.workloads import train as tt
    from tpu_dra_torch.workloads.launcher import run_local_group
    card()
    build_all()                      # built once, before the ranks load them
    child = Path(__file__).resolve().parent / "torch_process_child.py"
    repo = str(child.parent.parent)
    cfg = dict(vocab=256, d_model=256, n_heads=2, n_layers=2, d_ff=512,
               max_seq=64)
    gen = torch.Generator().manual_seed(0)
    params = tt.init_params(tt.ModelConfig(**cfg), gen)
    save_npz(tmp_path / "p.npz", params)
    np.savez(tmp_path / "t.npz", tokens=np.random.default_rng(0).integers(
        0, 256, (3, 4, 65)).astype(np.int32))
    (tmp_path / "optax_cases.json").write_text(json.dumps([{
        "name": "z1", "cfg": cfg, "kind": "optax", "params": "p.npz",
        "tokens": "t.npz", "impl": "dense", "attn": "flash", "zero1": True,
        "steps": 3}]))
    runs = {}
    for device in ("cpu", "cuda"):
        d = tmp_path / device
        d.mkdir()
        for f in ("p.npz", "t.npz", "optax_cases.json"):
            (d / f).symlink_to(tmp_path / f)
        run_local_group([sys.executable, str(child), "optax", str(d),
                         json.dumps({"dp": 2, "tp": 1}), device], 2,
                        timeout=300, cwd=repo,
                        env=dict(os.environ, PYTHONPATH=repo))
        runs[device] = []
        for r in range(2):
            with np.load(d / f"rank{r}.npz") as data:
                runs[device].append(({k: data[k] for k in data.files},
                                     json.loads((d / f"rank{r}.json")
                                                .read_text())))
    want, _ = runs["cpu"][0]
    replicated = 2 * 4 * sum(t.numel() for t in tt.tree_leaves(params))
    for got, info in runs["cuda"]:
        assert np.max(np.abs(got["z1_loss"] - want["z1_loss"])) < 5e-3
        for k, w in want.items():
            if k.startswith("z1_mu1/"):
                rel = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
                assert rel < 3e-2, (k, rel)
        held, said = info["cases"]["z1"]["bytes"]
        assert held == said and 2 * held == replicated


def test_process_zigzag_and_ici_shift_on_the_card_match_the_cpu(tmp_path):
    """Two processes on the card (one gloo group) run
    ``make_zigzag_ring_attention(impl="flash")`` on ``ProcessMesh({"sp":
    2})`` at [1, 2, 256, 64], MHA and GQA, and ``kv_handoff.ici_shift``
    of a bf16, int8 and fp32 tree one hop each way over its ring
    (tests/torch_process_child.py's ``attn`` mode): the global output and
    the q, k, v gradients within ``flash.ELEM_TOL`` of the same run in two
    processes on the CPU (the group plain versions), the shifts
    byte-equal, with 2n + 1 = 5 flash forwards and 5 of each backward
    kernel a call and one shift-kernel launch a leaf a direction in every
    process."""
    import json
    import os
    import sys
    from pathlib import Path

    import numpy as np

    from tpu_dra_torch.kernels.build import build_all
    from tpu_dra_torch.workloads import flash as tf
    from tpu_dra_torch.workloads.launcher import run_local_group
    card()
    build_all()                      # built once, before the ranks load them
    child = Path(__file__).resolve().parent / "torch_process_child.py"
    repo = str(child.parent.parent)
    (tmp_path / "attn.json").write_text(json.dumps({
        "shape": [1, 2, 256, 64], "zigzag": [["flash", 2], ["flash", 1]],
        "makers": []}))
    runs = {}
    for device in ("cpu", "cuda"):
        d = tmp_path / device
        d.mkdir()
        (d / "attn.json").symlink_to(tmp_path / "attn.json")
        run_local_group([sys.executable, str(child), "attn", str(d),
                         json.dumps({"sp": 2}), device], 2, timeout=300,
                        cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
        runs[device] = []
        for r in range(2):
            with np.load(d / f"rank{r}.npz") as data:
                runs[device].append(({k: data[k] for k in data.files},
                                     json.loads((d / f"rank{r}.json")
                                                .read_text())))
    tol = tf.ELEM_TOL
    for (got, info), (want, _) in zip(runs["cuda"], runs["cpu"]):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if k.startswith("shift_"):
                np.testing.assert_array_equal(got[k], w, err_msg=k)
            else:
                assert np.all(np.abs(got[k] - w) <= tol + tol * np.abs(w)), k
        for tag in ("zz_flash_kv2", "zz_flash_kv1"):
            assert info["calls"][tag] == [5, 5]
            assert info["launches"][tag] == [0, 5, 5, 5]
        assert info["launches"]["shift_right"] == 3
        assert info["launches"]["shift_left"] == 3


def _process_runs(tmp_path, mode: str, axes: dict, files: list) -> dict:
    """``mode`` of tests/torch_process_child.py in two processes on the CPU
    and then on the card, each in its own directory holding ``files``
    (linked from ``tmp_path``): per device, each rank's (arrays, info)."""
    import json
    import os
    import sys
    from pathlib import Path

    import numpy as np

    from tpu_dra_torch.kernels.build import build_all
    from tpu_dra_torch.workloads.launcher import run_local_group
    card()
    build_all()                      # built once, before the ranks load them
    child = Path(__file__).resolve().parent / "torch_process_child.py"
    repo = str(child.parent.parent)
    runs = {}
    for device in ("cpu", "cuda"):
        d = tmp_path / device
        d.mkdir()
        for f in files:
            (d / f).symlink_to(tmp_path / f)
        run_local_group([sys.executable, str(child), mode, str(d),
                         json.dumps(axes), device], 2, timeout=300,
                        cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
        runs[device] = []
        for r in range(2):
            with np.load(d / f"rank{r}.npz") as data:
                runs[device].append(({k: data[k] for k in data.files},
                                     json.loads((d / f"rank{r}.json")
                                                .read_text())))
    return runs


def test_process_moe_steps_on_the_card_match_the_cpu(tmp_path):
    """Two processes on the card (one gloo group) take the MoE SGD step
    at lr 1 and an AdamW step (``make_moe_train_step``,
    ``make_moe_optax_step``, flash attention) on ``ProcessMesh({"dp": 1,
    "ep": 2})`` (tests/torch_process_child.py's ``moe`` mode), a 2-layer
    top-2 model of head dim 128 with 4 experts, two a process, each
    replaying the routes of the same step on the CPU's virtual mesh
    (``moe.PinnedChoices``: the card's flash scores break near-ties
    otherwise, and after an AdamW step's ±lr moves a route flips and the
    next loss moves by 1e-2): the losses within 5e-3, each leaf's update
    and each first moment within 3% relative L2 of the same steps in two
    processes on the CPU, with 2·L flash forwards and L backwards a step
    in every process."""
    import json

    import numpy as np

    from tpu_dra_torch.convert import save_npz
    from tpu_dra_torch.workloads import moe as tm
    from tpu_dra_torch.workloads.mesh import Mesh
    cfg = dict(vocab=256, d_model=256, n_heads=2, n_layers=2, d_ff=512,
               max_seq=64, n_experts=4, router_top_k=2)
    mcfg = tm.MoEConfig(**cfg)
    params = tm.init_moe_params(mcfg, torch.Generator().manual_seed(0))
    save_npz(tmp_path / "p.npz", params)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 4, 65)).astype(
        np.int32)
    np.savez(tmp_path / "t.npz", tokens=tokens)
    step, _, _ = tm.make_moe_train_step(mcfg, Mesh({"dp": 1, "ep": 2},
                                                   device="cpu"),
                                        lr=1.0, attn_impl="flash")
    with tm.PinnedChoices() as pin:
        step(params, torch.from_numpy(tokens[0]))
    np.savez(tmp_path / "pins.npz", **{f"pin{i}": t.numpy()
                                       for i, t in enumerate(pin.recorded)})
    (tmp_path / "moe_cases.json").write_text(json.dumps([
        {"name": "sgd", "cfg": cfg, "kind": "sgd", "params": "p.npz",
         "tokens": "t.npz", "attn": "flash", "pins": "pins.npz"},
        {"name": "adamw", "cfg": cfg, "kind": "optax", "params": "p.npz",
         "tokens": "t.npz", "attn": "flash", "zero1": False, "steps": 1,
         "pins": "pins.npz"}]))
    runs = _process_runs(tmp_path, "moe", {"dp": 1, "ep": 2},
                         ["p.npz", "t.npz", "pins.npz", "moe_cases.json"])
    want, _ = runs["cpu"][0]
    p0 = {k: v.float().numpy() for k, v in _flat(params).items()}
    L = cfg["n_layers"]
    for got, info in runs["cuda"]:
        assert abs(float(got["sgd_pin_loss"][0])
                   - float(want["sgd_pin_loss"][0])) < 5e-3
        assert np.max(np.abs(got["adamw_loss"] - want["adamw_loss"])) < 5e-3
        for leaf, w0 in p0.items():
            gw = w0 - want[f"sgd_pin/{leaf}"]
            gg = w0 - got[f"sgd_pin/{leaf}"]
            assert np.linalg.norm(gg - gw) / np.linalg.norm(gw) < 3e-2, leaf
            w = want[f"adamw_mu1/{leaf}"]
            rel = np.linalg.norm(got[f"adamw_mu1/{leaf}"] - w) / \
                np.linalg.norm(w)
            assert rel < 3e-2, (leaf, rel)
        for case in ("sgd", "adamw"):
            assert info["cases"][case]["pins"] == [2 * L, 2 * L]
        assert info["cases"]["sgd"]["flash"] == [2 * L, L]


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: v})
    return out


def test_process_lora_steps_on_the_card_match_the_cpu(tmp_path):
    """Two processes on the card (one gloo group) take 2 LoRA steps
    (``make_lora_train_step``, flash attention) on ``ProcessMesh({"dp":
    1, "tp": 2})`` (tests/torch_process_child.py's ``lora`` mode), over
    a plain and an int8 base cut by ``serving_param_shardings``, a
    2-layer model of 4 heads over 2 kv heads of dim 128: the losses
    within 5e-3 and each adapter leaf's first moment after step 1 within
    3% relative L2 of the same steps in two processes on the CPU, the
    base untouched, with 2·L flash forwards and L backwards a step."""
    import json

    import numpy as np

    from tpu_dra_torch.convert import save_npz
    from tpu_dra_torch.workloads import lora as tl
    from tpu_dra_torch.workloads import train as tt
    cfg = dict(vocab=256, d_model=512, n_heads=4, n_kv_heads=2, n_layers=2,
               d_ff=1024, max_seq=64, pos_emb="rope")
    gen = torch.Generator().manual_seed(0)
    params = tt.init_params(tt.ModelConfig(**cfg), gen)
    lora = tl.init_lora(params, tl.LoRAConfig(rank=8), gen)
    for ab in lora["blocks"].values():
        ab["b"] = 0.02 * torch.randn(ab["b"].shape, generator=gen)
    save_npz(tmp_path / "p.npz", params)
    save_npz(tmp_path / "l.npz", lora)
    np.savez(tmp_path / "t.npz", tokens=np.random.default_rng(0).integers(
        0, 256, (2, 4, 65)).astype(np.int32))
    (tmp_path / "lora_cases.json").write_text(json.dumps([
        {"name": form, "cfg": cfg, "params": "p.npz", "lora": "l.npz",
         "tokens": "t.npz", "form": form, "group": 128, "attn": "flash",
         "steps": 2, "rank": 8} for form in ("plain", "int8")]))
    runs = _process_runs(tmp_path, "lora", {"dp": 1, "tp": 2},
                         ["p.npz", "l.npz", "t.npz", "lora_cases.json"])
    want, _ = runs["cpu"][0]
    L = cfg["n_layers"]
    for got, info in runs["cuda"]:
        for form in ("plain", "int8"):
            assert np.max(np.abs(got[f"{form}_loss"]
                                 - want[f"{form}_loss"])) < 5e-3
            for k, w in want.items():
                if k.startswith(f"{form}_mu1/"):
                    rel = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
                    assert rel < 3e-2, (k, rel)
            case = info["cases"][form]
            assert case["base_same"] and case["gathered"]
            assert case["flash"] == [2 * L * 2, L * 2]


def test_process_tp_paged_decode_on_the_card_matches_one_device(tmp_path):
    """Two processes on the card (one gloo group) decode tensor-parallel
    on ``ProcessMesh({"dp": 1, "tp": 2})`` from their int8 serving shards
    (tests/torch_process_child.py's ``decode`` mode): a 2-layer rope
    model of 8 heads over 2 kv heads of dim 64, 4 q heads over 1 kv head
    a process, 4 prompts of 24 tokens, 16 greedy steps on pages of 8.
    Every paged-attention launch (#1, on ``[B, 4, 64]`` a process) is
    held to its plain version on the same inputs (``SLOT_REL_TOL``), n
    layers a decode step in each process; the tokens equal the
    one-device paged decoder's on the card, except for a row that parts
    at a near-tie of the one-device logits (``argmax_tol``)."""
    import json

    import numpy as np

    from tpu_dra_torch.convert import save_npz
    from tpu_dra_torch.workloads import decode as td
    from tpu_dra_torch.workloads import quant as tq
    from tpu_dra_torch.workloads import train as tt
    from tpu_dra_torch.workloads.paged_kv import PagePool
    dev = card()
    cfg = dict(vocab=256, d_model=512, n_heads=8, n_kv_heads=2, n_layers=2,
               d_ff=1024, max_seq=64, pos_emb="rope")
    run = dict(steps=16, max_len=48, beams=2, beam_steps=2, k=2,
               page_size=8, total_pages=24)
    params = tt.init_params(tt.ModelConfig(**cfg),
                            torch.Generator().manual_seed(0))
    save_npz(tmp_path / "p.npz", params)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, (4, 24)).astype(np.int32)
    pool = PagePool(run["total_pages"], run["page_size"])
    need = pool.pages_for(24 + run["steps"])
    table = np.stack([pool.table_row(pool.alloc(need), need)
                      for _ in range(4)])
    np.savez(tmp_path / "decode_inputs.npz", prompt=prompt,
             beam_prompt=prompt, table=table)
    (tmp_path / "decode_cases.json").write_text(json.dumps({
        "run": run, "cases": [{"name": "int8", "cfg": cfg,
                               "params": "p.npz", "form": "int8",
                               "group": 128, "cache": "bf16",
                               "beam": False, "paged_only": True}]}))
    runs = _process_runs(tmp_path, "decode", [{"dp": 1, "tp": 2}],
                         ["p.npz", "decode_inputs.npz",
                          "decode_cases.json"])
    tcfg = tt.ModelConfig(**cfg)
    tree = _to_card(tq.quantize_params_int8(params), dev)
    tp = torch.from_numpy(prompt).to(dev)
    from tpu_dra_torch.workloads.paged_kv import paged_greedy_decode
    want = paged_greedy_decode(
        tcfg, tree, tp, torch.from_numpy(table).to(dev),
        steps=run["steps"], total_pages=run["total_pages"],
        page_size=run["page_size"]).cpu().numpy()
    for got, info in runs["cuda"]:
        seen = info["paged_check"]
        assert seen["calls"] == cfg["n_layers"] * (run["steps"] - 1)
        assert seen["max_slot_rel"] <= tpk.SLOT_REL_TOL, seen
        toks = got["dp1xtp2/int8/paged"].astype(np.int32)
        for b in range(4):
            diff = np.flatnonzero(toks[b] != want[b])
            if diff.size:
                i = int(diff[0])
                cache = td.init_kv_cache(tcfg, 1, run["max_len"],
                                         device=dev)
                row = torch.cat([tp[b:b + 1], torch.from_numpy(
                    want[b:b + 1, :i]).to(dev)], dim=1)
                _, lg = td.prefill(tcfg, tree, cache, row)
                top2 = lg[0].float().topk(2).values.tolist()
                tol = 2 * max(2 ** -4, 2 ** -6 * abs(top2[0]))
                assert top2[0] - top2[1] <= tol, (b, i, top2, tol)
    np.testing.assert_array_equal(runs["cuda"][0][0]["dp1xtp2/int8/paged"],
                                  runs["cuda"][1][0]["dp1xtp2/int8/paged"])


def _to_card(tree: dict, dev) -> dict:
    return {k: _to_card(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
