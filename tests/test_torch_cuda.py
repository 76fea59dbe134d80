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


# --------------------------------------------------------------------------
# the fused flash backward (workloads/flash.py flash_bwd_fused)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    (8, 8, 300, 128, True, None), (8, 2, 200, 64, True, None),
    (8, 2, 100, 128, False, 300), (4, 4, 2048, 128, True, None),
    (4, 1, 2500, 64, False, None), (8, 2, 1000, 128, False, None)],
    ids=["mha-300", "gqa4-d64-200", "cross-100x300", "two-blocks-2048",
         "mqa-three-blocks-2500", "gqa4-full-1000"])
def test_flash_fused_kernel_matches_plain(shape):
    """dq (from the kernel's fp32 sums per KV_BLOCK keys: one to three
    blocks here, the last ragged), and per-q-head dk, dv, against
    flash_bwd_fused_ref."""
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
                                 (2048, 1024, 640)])
def test_matmul_kernel_matches_plain(mkn):
    """Ragged tiles in every dimension: m 200 and 1000, k 40 (one partial
    32-deep tile), n 264, 72 and 8."""
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
