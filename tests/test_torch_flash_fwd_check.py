"""The check that holds the flash forward kernel to its plain version
(out elementwise within ``flash.ELEM_TOL`` and each head-row within
``flash.ROW_TOL["out"]`` by ``flash.row_rel_err``, l2 within
``flash.L2_ATOL``, as chip_smoke.py and tests/test_torch_cuda.py apply
it) has teeth, for the kernel's own tiling.

The kernel (``csrc/flash_fwd.cu``) cannot run here, so its arithmetic is
replayed in PyTorch with its constants: blocks of 128 q rows, each two
64-row halves with their own running max and sum (the two consumer
warpgroups), walking 128-key tiles of K and V that TMA zero-fills past
Sk; under the causal mask a block stops after the tile that holds its
last row's diagonal.  q is pre-scaled and rounded to bf16; qs·Kᵀ is
summed over D in 16-wide k-steps in fp32; the mask applies only on tiles
that cross the diagonal or the ragged key tail; p = exp2(s − m) against
the running max m (the safe_m rule for rows masked so far), l sums the
unrounded p, the accumulator is scaled by the correction factor and adds
bf16(p)·V in 16-key k-steps; out = acc · (1 / max(l, 1e-30)) rounded
once and l2 = m + log2(max(l, 1e-30)).  That replay must pass the check against
``flash_attn_fwd_ref`` at the path's head shape (S 1024, D 128, causal;
and non-causal with S ≠ Sk and a ragged key tail), and against the JAX
reference kernel in interpret mode at a small size; the same replay with
a planted fault must fail it.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import f32

from tpu_dra.workloads import pallas_kernels as pk
from tpu_dra_torch.workloads import flash as tf
from tpu_dra_torch.workloads.train import weak_scalar

BQ, HALF, BK, KSTEP = 128, 64, 128, 16
NEG = torch.finfo(torch.float32).min


def bf16_case(seed: int, bh: int, bhkv: int, s: int, sk: int, d: int):
    """bf16 q [bh, s, d] and k/v [bhkv, sk, d] from a numpy seed."""
    r = np.random.default_rng(seed)

    def draw(n, length):
        return torch.from_numpy(r.standard_normal(
            (n, length, d)).astype(np.float32)).bfloat16()
    return draw(bh, s), draw(bhkv, sk), draw(bhkv, sk)


# (BH, BHkv, S, Sk, causal) at D 128: the training path's head shape, and
# the non-causal cross-length case whose last key tile is ragged (Sk = 1000
# = 7 · 128 + 104), GQA g = 2
CASES = {"causal-1024": (4, 4, 1024, 1024, True),
         "full-ragged": (4, 2, 1024, 1000, False)}


@functools.lru_cache(maxsize=None)
def case(name: str):
    bh, bhkv, s, sk, causal = CASES[name]
    q, k, v = bf16_case(11, bh, bhkv, s, sk, 128)
    return (q, k, v, causal), tf.flash_attn_fwd_ref(q, k, v, causal)


def fwd_replay(q, k, v, causal: bool, fault=None):
    """The forward kernel's arithmetic, optionally with a planted ``fault``:

    - ``diag-off-by-one``: the causal mask lets each row see one key past
      its diagonal (col > row + 1 instead of col > row);
    - ``skip-last-tile``: every block stops one k tile early;
    - ``l-from-rounded-p``: l sums bf16(p) instead of the fp32 p;
    - ``no-correction``: the accumulator is not scaled when the max moves;
    - ``q-unrounded``: the pre-scaled q stays fp32;
    - ``tail-unmasked``: the zero-filled keys past Sk are not masked.
    """
    bh, s, d = q.shape
    bhkv, sk, _ = k.shape
    g = bh // bhkv
    n_kt = -(-sk // BK)
    pad = n_kt * BK - sk

    def tiles(t):                        # TMA's zero fill past Sk, per q head
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, pad))
        return t.repeat_interleave(g, dim=0)
    kf, vf = tiles(k), tiles(v)
    qs = q.float() * weak_scalar(d ** -0.5 * tf._LOG2E, torch.bfloat16)
    if fault != "q-unrounded":
        qs = qs.bfloat16().float()
    qs = torch.nn.functional.pad(qs, (0, 0, 0, -(-s // BQ) * BQ - s))
    out = torch.zeros((bh, s, d), dtype=torch.bfloat16)
    l2 = torch.zeros((bh, s, 1))
    for q0 in range(0, s, BQ):
        kv_end = min(sk, q0 + BQ) if causal else sk
        n_k = -(-kv_end // BK) - (fault == "skip-last-tile")
        for r0 in range(q0, min(q0 + BQ, s), HALF):
            qh = qs[:, r0:r0 + HALF]
            rows = torch.arange(r0, r0 + HALF)[:, None]
            m = torch.full((bh, HALF), NEG)
            l = torch.zeros((bh, HALF))
            acc = torch.zeros((bh, HALF, d))
            for j in range(n_k):
                k0 = j * BK
                sc = torch.zeros((bh, HALF, BK))
                for c in range(0, d, KSTEP):
                    sc += qh[..., c:c + KSTEP] @ \
                        kf[:, k0:k0 + BK, c:c + KSTEP].transpose(1, 2)
                if k0 + BK > sk or (causal and k0 + BK - 1 > r0):
                    cols = torch.arange(k0, k0 + BK)[None, :]
                    dead = torch.zeros((HALF, BK), dtype=torch.bool)
                    if fault != "tail-unmasked":
                        dead |= cols >= sk
                    if causal:
                        dead |= cols > rows + (fault == "diag-off-by-one")
                    sc = sc.masked_fill(dead, NEG)
                m_new = torch.maximum(m, sc.amax(dim=-1))
                safe = torch.where(m_new == NEG, 0.0, m_new)
                corr = torch.where(m == NEG, 0.0, torch.exp2(m - safe))
                p = torch.where(sc == NEG, 0.0,
                                torch.exp2(sc - safe[..., None]))
                pb = p.bfloat16().float()
                l = l * corr + (pb if fault == "l-from-rounded-p"
                                else p).sum(dim=-1)
                if fault != "no-correction":
                    acc = acc * corr[..., None]
                for c in range(0, BK, KSTEP):
                    acc += pb[..., c:c + KSTEP] @ vf[:, k0 + c:k0 + c + KSTEP]
                m = m_new
            n = min(HALF, s - r0)
            lc = l.clamp_min(1e-30)[:, :n]
            out[:, r0:r0 + n] = (acc[:, :n] * (1.0 / lc)[..., None]).bfloat16()
            l2[:, r0:r0 + n, 0] = m[:, :n] + torch.log2(lc)
    return out, l2


def verdict(got, want):
    """(every check passes, worst elementwise share of ELEM_TOL, worst
    head-row error as a share of ROW_TOL["out"], worst l2 error as a share
    of L2_ATOL)."""
    (out, l2), (w_out, w_l2) = got, want
    diff = (out.float() - w_out.float()).abs()
    elem = float((diff / (tf.ELEM_TOL + tf.ELEM_TOL
                          * w_out.float().abs())).max())
    row = float(tf.row_rel_err(out, w_out).max()) / tf.ROW_TOL["out"]
    lse = float((l2 - w_l2).abs().max()) / tf.L2_ATOL
    return max(elem, row, lse) <= 1, elem, row, lse


@pytest.mark.parametrize("name", sorted(CASES))
def test_clean_replay_passes_the_check(name):
    args, want = case(name)
    ok, elem, row, lse = verdict(fwd_replay(*args), want)
    assert ok, (elem, row, lse)
    assert elem < 0.5 and row < 0.5 and lse < 0.5, (elem, row, lse)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_clean_replay_passes_the_check_against_the_jax_kernel(causal):
    """At a small size the same check holds the replay to the reference's
    own kernel, ``_flash_attn_fwd`` in interpret mode with 64-blocks, run
    as tests/test_torch_flash.py runs it: two q blocks of 128 and, for
    GQA, the grouped kernel."""
    for bh, bhkv in ((2, 2), (4, 2)):
        q, k, v = bf16_case(12, bh, bhkv, 256, 256, 64)
        jo, jl = pk._flash_attn_fwd(
            *(jnp.asarray(f32(t), jnp.bfloat16) for t in (q, k, v)),
            causal=causal, bq=64, bk=64, interpret=True)
        want = torch.tensor(f32(jo)).bfloat16(), torch.tensor(f32(jl))
        ok, elem, row, lse = verdict(fwd_replay(q, k, v, causal), want)
        assert ok, (bh, bhkv, elem, row, lse)


# each fault with the case that exposes it: the mask faults and the
# dropped tile under the causal mask, the unmasked tail where Sk is ragged
FAULTS = {"diag-off-by-one": "causal-1024", "skip-last-tile": "causal-1024",
          "l-from-rounded-p": "causal-1024", "no-correction": "causal-1024",
          "q-unrounded": "causal-1024", "tail-unmasked": "full-ragged"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_check(fault):
    args, want = case(FAULTS[fault])
    ok, elem, row, lse = verdict(fwd_replay(*args, fault=fault), want)
    # the rounding-point faults (l from bf16(p), q unrounded) move l2 by
    # more than its tolerance while out stays inside its own; the others
    # fail out by a wide margin
    assert not ok and max(elem, row, lse) > 2, (fault, elem, row, lse)
