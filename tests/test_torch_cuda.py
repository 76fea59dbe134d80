"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: each test skips where CUDA is absent, and the
suite runs them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

(chip_smoke.py holds the same kernels to the same versions at the
serving and training paths' full shapes; these cover the other shapes
the kernels take, and the flash wrappers' refusals.)
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


def test_flash_attention_autograd_on_the_card_matches_plain():
    """The front door through FlashAttention: GQA grads group-summed."""
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
