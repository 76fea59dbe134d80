"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: each test skips where CUDA is absent, and the
suite runs them on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

(chip_smoke.py holds the same kernels to the same versions at the
serving path's full shapes; these cover the other shapes the kernel
takes.)
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
