"""The check that holds the CUDA paged-attention kernel to its plain
version (``paged_kv.slot_rel_err`` within ``SLOT_REL_TOL``, as used by
chip_smoke.py and tests/test_torch_cuda.py) has teeth.

The kernel cannot run here, so its arithmetic is replayed in PyTorch at
the serving path's shapes (B 32, H 8 over Hkv 2, Dh 128, 64-token pages,
16 table columns, lengths up to 1024): q pre-scaled into base 2 and
rounded to bf16, 8-token tiles dealt round-robin to 8 warps, each warp an
online softmax whose p is rounded to bf16 before P.V while l sums the
unrounded p, the warps merged at the end.  That replay must pass the
check; the same replay with one planted fault in long slots must not.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tpu_dra_torch.workloads import paged_kv as tpk
from tpu_dra_torch.workloads.quant import quantize_kv
from tpu_dra_torch.workloads.train import weak_scalar

B, H, HKV, DH, P, PS, MP = 32, 8, 2, 128, 160, 64, 16
WARPS, TILE = 8, 8
# the reference's elementwise kernel-vs-oracle tolerances
ELEMENTWISE = {"bf16": 0.05, "int8": 0.08}


@functools.lru_cache(maxsize=None)
def case(cache_dtype: str):
    """Decode-step inputs at the path's shapes from a numpy seed:
    scrambled pages, -1 tails, lengths 0, 1, page edges, mid-page, the
    full table and 24 random ones."""
    r = np.random.default_rng(7)
    lengths = [0, 1, PS, PS + 1, 100, MP * PS, 2 * PS - 1, 7 * PS + 33]
    lengths += r.integers(1, MP * PS + 1, B - len(lengths)).tolist()

    def bf16(shape):
        return torch.from_numpy(
            r.standard_normal(shape).astype(np.float32)).bfloat16()
    q, k, v = bf16((B, H, DH)), bf16((HKV, P, PS, DH)), bf16((HKV, P, PS, DH))
    lengths = torch.tensor(lengths, dtype=torch.int32)
    used = (lengths + PS - 1) // PS
    pages = torch.from_numpy(r.integers(0, P, (B, MP)).astype(np.int32))
    table = torch.where(torch.arange(MP)[None] < used[:, None], pages,
                        torch.full_like(pages, -1))
    scales = {}
    if cache_dtype == "int8":
        k, k_s = quantize_kv(k)
        v, v_s = quantize_kv(v)
        scales = {"k_s": k_s, "v_s": v_s}
    args = (q, k, v, table, lengths)
    return args, scales, tpk.paged_attention_ref(*args, **scales)


def kernel_replay(q, k, v, table, lengths, k_s=None, v_s=None, fault=None):
    """The CUDA kernel's arithmetic, optionally with a planted ``fault``
    in slots longer than 512 tokens:

    - ``drop-tile``: tile 40 (tokens 320-327) is skipped;
    - ``late-page``: tokens of table column 12 are read from column 11's
      page;
    - ``int8-scale``: the v scales of table column 9 are 10% too large.
    """
    G, S = H // HKV, MP * PS
    long_slot = lengths > 512
    tab = table.clamp(min=0).long()

    def rows(pages, scale, col_fault):
        page_ids = tab.clone()
        if fault == "late-page":
            page_ids[long_slot, 12] = page_ids[long_slot, 11]
        x = pages[:, page_ids].permute(1, 0, 2, 3, 4).reshape(
            B, HKV, S, -1).float()
        if scale is None:
            return x
        s = scale[:, page_ids].permute(1, 0, 2, 3, 4).reshape(B, HKV, S, 1)
        if col_fault:
            s = s.clone()
            s[long_slot, :, 9 * PS:10 * PS] *= 1.1
        return (x * s).bfloat16().float()     # int8 rows dequantize to bf16

    kf = rows(k, k_s, False)
    vf = rows(v, v_s, fault == "int8-scale")
    qs = q * weak_scalar(DH ** -0.5 * 1.4426950408889634, torch.bfloat16)
    s = torch.einsum("bkgd,bksd->bkgs", qs.float().reshape(B, HKV, G, DH),
                     kf)
    live = torch.arange(S)[None] < lengths[:, None].long()       # [B, S]
    neg = torch.tensor(float("-inf"))
    m = torch.full((WARPS, B, HKV, G), float("-inf"))
    l = torch.zeros((WARPS, B, HKV, G))
    acc = torch.zeros((WARPS, B, HKV, G, DH))
    for t in range(S // TILE):
        w, cols = t % WARPS, slice(t * TILE, (t + 1) * TILE)
        on = live[:, cols]
        run = on.any(1)
        if fault == "drop-tile" and t == 40:
            run &= ~long_slot
        run = run[:, None, None]
        st = torch.where(on[:, None, None], s[..., cols], neg)
        m_new = torch.maximum(m[w], st.amax(-1))
        corr = torch.exp2(m[w] - m_new)
        p = torch.exp2(st - m_new[..., None])
        pv = torch.einsum("bkgi,bkid->bkgd", p.bfloat16().float(),
                          vf[:, :, cols])
        acc[w] = torch.where(run[..., None], acc[w] * corr[..., None] + pv,
                             acc[w])
        l[w] = torch.where(run, l[w] * corr + p.sum(-1), l[w])
        m[w] = torch.where(run, m_new, m[w])
    f = torch.where(torch.isfinite(m), torch.exp2(m - m.amax(0)),
                    torch.zeros_like(m))
    lsum = (l * f).sum(0)
    out = (acc * f[..., None]).sum(0) / torch.where(
        lsum == 0, torch.ones_like(lsum), lsum)[..., None]
    return out.reshape(B, H, DH).bfloat16()


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_check_admits_the_kernels_own_rounding(cache_dtype):
    args, scales, want = case(cache_dtype)
    got = kernel_replay(*args, **scales)
    err = tpk.slot_rel_err(got, want)
    assert bool((got[0] == 0).all()) and float(err[0]) == 0.0
    # the replay sits well inside the tolerance, with room for another
    # summation order on the card
    assert float(err.max()) < 0.75 * tpk.SLOT_REL_TOL, err.max()
    tol = ELEMENTWISE[cache_dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("cache_dtype,fault", [
    ("bf16", "drop-tile"), ("int8", "drop-tile"),
    ("bf16", "late-page"), ("int8", "late-page"),
    ("int8", "int8-scale")])
def test_check_catches_a_fault_in_long_slots(cache_dtype, fault):
    args, scales, want = case(cache_dtype)
    lengths = args[4]
    err = tpk.slot_rel_err(kernel_replay(*args, **scales, fault=fault), want)
    assert not bool((err[lengths <= 512] > tpk.SLOT_REL_TOL).any())
    assert float(err.max()) > tpk.SLOT_REL_TOL, err.max()
