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
    assert cm.all_gather_matmul.launches == before + n
    want_y, want_a = cm.all_gather_matmul_ref(x, w)
    assert torch.equal(a, want_a)
    _ring_close(y, want_y)


@pytest.mark.parametrize("n,m", [(3, 64), (4, 130), (8, 32)])
def test_bidirectional_and_unidirectional_rings_agree_bit_for_bit(n, m):
    """The same even-m inputs through both schedules (the C entry takes
    the direction as a flag): every row's product is the same sum."""
    from tpu_dra_torch.kernels.build import library
    dev = card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(n * m)
    x, w = _ring_operands(gen, 1, n, m, 64, 96)
    lib = library("ring")
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for bidir in (1, 0):
        y = torch.empty((1, n, n * m, 96), dtype=torch.bfloat16, device=dev)
        a = torch.empty((1, n, n, m, 64), dtype=torch.bfloat16, device=dev)
        for step in range(n):
            assert lib.tpu_dra_ring_ag_matmul(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), a.data_ptr(), 1, n,
                m, 64, 96, m * 64, n * m * 64, w.stride(1), 0, step, bidir,
                stream) == 0
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
    assert cm.matmul_reduce_scatter.launches == before + n
    _ring_close(y, cm.matmul_reduce_scatter_ref(x, w))


@pytest.mark.parametrize("m,K,N", [(100, 72, 264), (256, 512, 512)])
def test_ring_matmul_kernels_at_one_rank(m, K, N):
    """The C entries at n 1 (the wrappers take the plain product there
    and launch nothing): the gather's one step is x·w with a = x, the
    reduce-scatter's one step rounds x·w into y."""
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
    assert lib.tpu_dra_ring_ag_matmul(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), a.data_ptr(), 1, 1, m, K,
        N, m * K, m * K, K * N, 0, 0, 0, stream) == 0
    torch.cuda.synchronize()
    want_y, want_a = cm.all_gather_matmul_ref(x, w)
    assert torch.equal(a, want_a)
    _ring_close(y, want_y)
    comm = torch.empty((1, 1, 2, m, N), dtype=torch.float32, device=dev)
    y2 = torch.empty_like(y)
    assert lib.tpu_dra_ring_matmul_rs(
        x.data_ptr(), w.data_ptr(), comm.data_ptr(), y2.data_ptr(), 1, 1, m,
        K, N, m * K, m * K, K * N, 0, 0, stream) == 0
    torch.cuda.synchronize()
    _ring_close(y2, cm.matmul_reduce_scatter_ref(x, w))


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
