"""The check that holds the CUDA paged-attention kernel to its plain
version (``paged_kv.slot_rel_err`` within ``SLOT_REL_TOL``, as used by
chip_smoke.py and tests/test_torch_cuda.py) has teeth.

The kernel cannot run here, so its arithmetic is replayed in PyTorch at
the serving path's shapes (B 32, H 8 over Hkv 2, Dh 128, 64-token pages,
16 table columns, lengths up to 1024), with the tile and span sizes read
from ``csrc/paged_attention.cu``: q pre-scaled into base 2 and rounded to
bf16; each (slot, kv head) cut into spans of ``kSpanTokens`` tokens, a
span that starts at or past the length skipped; each live span an online
softmax over its ``kTile``-token tiles, whose p is rounded to bf16 before
P.V while l sums the unrounded p; then the live spans' partials merged in
span order, each rescaled from its own max to the slot's.  That replay
must pass the check; the same replay with one planted fault must not.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_dra_torch.workloads import paged_kv as tpk
from tpu_dra_torch.workloads.quant import quantize_kv
from tpu_dra_torch.workloads.train import weak_scalar

SOURCE = (Path(__file__).resolve().parent.parent / "tpu_dra_torch" / "csrc"
          / "paged_attention.cu").read_text()


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


B, H, HKV, DH, P, PS, MP = 32, 8, 2, 128, 160, 64, 16
TILE, SPAN = constant("kTile"), constant("kSpanTokens")
# the reference's elementwise kernel-vs-oracle tolerances
ELEMENTWISE = {"bf16": 0.05, "int8": 0.08}


def test_the_replay_reads_the_kernel_it_models():
    """The sizes and expressions the replay models, as the source writes
    them, and the wrapper's workspace sized by the same span."""
    assert tpk.SPAN_TOKENS == SPAN and SPAN % TILE == 0
    for line in (
            "if (t0 >= len) return;                           // a dead span",
            "const int t1 = min(t0 + kSpanTokens, len);",
            "page = page < 0 ? 0 : page;",
            "sS[gq * kTile + i0] = tok0 + i0 < t1 ? c[0] : -INFINITY;",
            "const float corr = exp2f(m_run[jr] - m_new);",
            "l_run[jr] = l_run[jr] * corr + warp_sum(psum);",
            "sP[r * kTile + lane + 32 * jt] = round_bf16(p);",
            "const int live = (len + kSpanTokens - 1) / kSpanTokens;",
            "for (int s = 0; s < live; ++s) mx = fmaxf(mx, "
            "rec0[s * kRec + G * DH + r]);",
            "const float f = exp2f(rec[G * DH + r] - mx);",
            "__float2bfloat16(a / (lsum == 0.f ? 1.f : lsum));",
            "constexpr int kRec = G * (DH + 2);",
            "const int n_spans = (MP * ps + kSpanTokens - 1) / kSpanTokens;"):
        assert line in SOURCE, line
    assert tpk.workspace_floats(B, H, HKV, DH, MP, PS) == (
        B * HKV * -(-MP * PS // SPAN) * (H // HKV) * (DH + 2))


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
    """The CUDA kernel's arithmetic, optionally with a planted ``fault``:

    in slots longer than 512 tokens
    - ``drop-tile``: the tile that holds token 320 is skipped;
    - ``late-page``: tokens of table column 12 are read from column 11's
      page;
    - ``int8-scale``: the v scales of table column 9 are 10% too large;

    in every slot
    - ``no-rescale``: the merge adds the spans' partials without rescaling
      each from its own max to the slot's;
    - ``dead-span``: the merge takes every span of the slot, a dead one's
      partial (m = −inf, l = 0, acc = 0) included;
    - ``tail-unmasked``: the tokens from the length to the end of its last
      page are scored as live.
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
    ends = lengths.long()
    if fault == "tail-unmasked":
        ends = (ends + PS - 1) // PS * PS
    live = torch.arange(S)[None] < ends[:, None]                 # [B, S]
    neg = torch.tensor(float("-inf"))
    n_spans = -(-S // SPAN)
    pm = torch.full((n_spans, B, HKV, G), float("-inf"))
    pl = torch.zeros((n_spans, B, HKV, G))
    pacc = torch.zeros((n_spans, B, HKV, G, DH))
    for sp in range(n_spans):
        m, l, acc = pm[sp], pl[sp], pacc[sp]
        for t in range(sp * SPAN // TILE, (sp + 1) * SPAN // TILE):
            cols = slice(t * TILE, (t + 1) * TILE)
            on = live[:, cols]
            run = on.any(1)
            if fault == "drop-tile" and t == 320 // TILE:
                run &= ~long_slot
            run = run[:, None, None]
            st = torch.where(on[:, None, None], s[..., cols], neg)
            m_new = torch.maximum(m, st.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(st - m_new[..., None])
            pv = torch.einsum("bkgi,bkid->bkgd", p.bfloat16().float(),
                              vf[:, :, cols])
            acc = torch.where(run[..., None], acc * corr[..., None] + pv, acc)
            l = torch.where(run, l * corr + p.sum(-1), l)
            m = torch.where(run, m_new, m)
        pm[sp], pl[sp], pacc[sp] = m, l, acc
    # the merge of each slot's live spans, in span order
    n_live = (-(-ends // SPAN)).clamp(max=n_spans)
    if fault == "dead-span":
        n_live = torch.full_like(n_live, n_spans)
    taken = (torch.arange(n_spans)[:, None] < n_live[None])[:, :, None, None]
    mx = torch.where(taken, pm, neg).amax(0)
    f = torch.exp2(pm - mx)
    if fault == "no-rescale":
        f = torch.ones_like(f)
    f = torch.where(taken, f, torch.zeros_like(f))
    lsum = (pl * f).sum(0)
    out = (pacc * f[..., None]).sum(0) / torch.where(
        lsum == 0, torch.ones_like(lsum), lsum)[..., None]
    return out.reshape(B, H, DH).bfloat16()


def check_holds(got, want, cache_dtype: str) -> bool:
    """chip_smoke.py's check of the kernel against its plain version:
    finite, zeros for the zero-length slot, elementwise within the
    reference's tolerance, and every slot within SLOT_REL_TOL."""
    gf, wf = got.float(), want.float()
    tol = ELEMENTWISE[cache_dtype]
    return (bool(torch.isfinite(gf).all())
            and bool((gf[0] == 0).all())
            and bool(((gf - wf).abs() <= tol + tol * wf.abs()).all())
            and bool((tpk.slot_rel_err(got, want) <= tpk.SLOT_REL_TOL).all()))


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
    assert check_holds(got, want, cache_dtype)


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


@pytest.mark.parametrize("cache_dtype,fault", [
    ("bf16", "no-rescale"), ("int8", "no-rescale"),
    ("bf16", "dead-span"), ("int8", "dead-span"),
    ("bf16", "tail-unmasked"), ("int8", "tail-unmasked")])
def test_check_catches_a_fault_in_the_span_merge(cache_dtype, fault):
    args, scales, want = case(cache_dtype)
    assert not check_holds(kernel_replay(*args, **scales, fault=fault), want,
                           cache_dtype)


def test_the_merge_faults_show_where_expected():
    """Where each merge fault shows: without the rescale only in slots of
    more than one live span; a dead span's partial only in the zero-length
    slot (NaN: -inf − -inf); an unmasked tail only in slots whose length
    ends inside a page."""
    args, scales, want = case("bf16")
    lengths = args[4]
    multi = lengths > SPAN
    err = tpk.slot_rel_err(kernel_replay(*args, fault="no-rescale"), want)
    assert not bool((err[~multi] > 0.75 * tpk.SLOT_REL_TOL).any())
    assert bool((err[multi] > tpk.SLOT_REL_TOL).all())
    got = kernel_replay(*args, fault="dead-span").float()
    assert bool(torch.isnan(got[0]).all())
    assert bool(torch.isfinite(got[1:]).all())
    err = tpk.slot_rel_err(kernel_replay(*args, fault="tail-unmasked"), want)
    edge = (lengths % PS == 0)
    assert not bool((err[edge] > 0.75 * tpk.SLOT_REL_TOL).any())
    assert float(err[~edge].max()) > tpk.SLOT_REL_TOL
