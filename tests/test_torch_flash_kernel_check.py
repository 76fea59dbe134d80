"""The check that holds the flash dK/dV kernel to its plain version
(elementwise within ``flash.ELEM_TOL`` and each head-row within
``flash.ROW_TOL`` by ``flash.row_rel_err``, as chip_smoke.py and
tests/test_torch_cuda.py apply it) has teeth.

The kernel cannot run here, so its arithmetic is replayed in PyTorch at
the training path's head shape (S 1024, D 128, causal): one block per
64-key tile walks 32-row q tiles from the one that holds its first key
down to S; the D-sums k·qsᵀ and V·dOᵀ are taken in 16-wide k-steps as
its mma instructions take them; P = exp2(k·qsᵀ − l2) in fp32, masked
where a query precedes its key; dV accumulates bf16(P)ᵀ·dO and dK
accumulates bf16(dS)ᵀ·qs in fp32 with dS = P∘(V·dOᵀ − dd) from the fp32
P; dK is scaled by 1/log2e and both are rounded to bf16 once.  That
replay must pass the check; the same replay with a structural fault must
not.

The replay is cleaner than the kernel: the tensor cores do not add in
strict fp32, and the cancellation in V·dOᵀ − dd turns that into bf16
flips of dS, so on an H100 80GB HBM3 at 700 W the kernel scores ~0.3
of the head-row tolerance (PERF.md §6) where the replay scores ~0.07.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tpu_dra_torch.workloads import flash as tf

BH, S, D = 4, 1024, 128
BK, BQ2 = 64, 32


@functools.lru_cache(maxsize=None)
def case():
    """Path-shaped inputs from a numpy seed, with out/l2 from the plain
    forward (the backward kernels' inputs)."""
    r = np.random.default_rng(9)

    def bf16(shape):
        return torch.from_numpy(
            r.standard_normal(shape).astype(np.float32)).bfloat16()
    q, k, v, do = (bf16((BH, S, D)) for _ in range(4))
    out, l2 = tf.flash_attn_fwd_ref(q, k, v)
    qs = tf._prescale(q)
    dd = (do.float() * out.float()).sum(-1, keepdim=True)
    want = tf.flash_bwd_dkdv_ref(qs, k, v, do, l2, dd)
    return (qs, k, v, do, l2, dd), want


def ksteps(a, b):
    """``a·bᵀ`` over D summed as the kernel's mma instructions sum it: one
    fp32 partial per 16-wide k-step, added in order."""
    acc = torch.zeros(a.shape[:2] + b.shape[1:2])
    for c in range(0, D, 16):
        acc += a[..., c:c + 16] @ b[..., c:c + 16].transpose(1, 2)
    return acc


def dkdv_replay(qs, k, v, do, l2, dd, fault=None):
    """The dK/dV kernel's arithmetic, optionally with a planted ``fault``:

    - ``late-start``: blocks of keys >= 512 start one q tile late, so the
      queries on their diagonal tile never reach them;
    - ``skip-tile``: q tile 30 (rows 960-991) is skipped by every block;
    - ``strict-mask``: the causal mask drops the diagonal (query > key
      instead of query >= key);
    - ``ds-rounded-p``: dS is formed from bf16(P) instead of the fp32 P.
    """
    dk = torch.zeros((BH, S, D))
    dv = torch.zeros((BH, S, D))
    qsf, dof = qs.float(), do.float()
    l2r, ddr = l2[..., 0], dd[..., 0]
    for k0 in range(0, S, BK):
        kb, vb = k[:, k0:k0 + BK].float(), v[:, k0:k0 + BK].float()
        keys = torch.arange(k0, k0 + BK)[:, None]
        start = k0 + (BQ2 if fault == "late-start" and k0 >= 512 else 0)
        for q0 in range(start, S, BQ2):
            if fault == "skip-tile" and q0 == 30 * BQ2:
                continue
            qt, dot = qsf[:, q0:q0 + BQ2], dof[:, q0:q0 + BQ2]
            rows = torch.arange(q0, q0 + BQ2)[None, :]
            keep = rows > keys if fault == "strict-mask" else rows >= keys
            p = torch.where(keep, torch.exp2(
                ksteps(kb, qt) - l2r[:, None, q0:q0 + BQ2]), 0.0)
            pb = p.bfloat16().float()
            dv[:, k0:k0 + BK] += pb @ dot
            dp = ksteps(vb, dot)
            ds = (pb if fault == "ds-rounded-p" else p) * (
                dp - ddr[:, None, q0:q0 + BQ2])
            dk[:, k0:k0 + BK] += ds.bfloat16().float() @ qt
    dk = (dk * (1.0 / tf._LOG2E)).bfloat16()
    return dk, dv.bfloat16()


def verdict(got, want):
    """(elementwise ok, worst elementwise share of the tolerance, worst
    head-row error, head-row ok) for dk and dv together."""
    ratio, row = 0.0, 0.0
    for g, w, name in zip(got, want, ("dk", "dv")):
        diff = (g.float() - w.float()).abs()
        ratio = max(ratio, float((diff / (tf.ELEM_TOL + tf.ELEM_TOL
                                          * w.float().abs())).max()))
        row = max(row, float(tf.row_rel_err(g, w).max()) / tf.ROW_TOL[name])
    return ratio <= 1, ratio, row, row <= 1


def test_clean_replay_passes_the_check():
    args, want = case()
    elem_ok, ratio, row, row_ok = verdict(dkdv_replay(*args), want)
    assert elem_ok and row_ok, (ratio, row)
    assert ratio < 0.5 and row < 0.25, (ratio, row)


@pytest.mark.parametrize("fault", ["late-start", "skip-tile",
                                   "strict-mask"])
def test_planted_fault_fails_the_check(fault):
    args, want = case()
    elem_ok, ratio, row, row_ok = verdict(dkdv_replay(*args, fault=fault),
                                          want)
    # each fails the head-row check by a wide margin (12x to 100x on this
    # replay); the elementwise check fails too
    assert row > 5 and not elem_ok, (fault, ratio, row)


def test_ds_rounding_point_sits_at_the_edge_of_the_check():
    """dS formed from bf16(P) instead of the fp32 P: the elementwise check
    cannot see it, and it lands at about the head-row tolerance itself
    (1.08x on this replay), so against the kernel's own noise the check
    may or may not catch it.  The kernel source pins this rounding point
    (flash_bwd.cu); no output check is relied on for it."""
    args, want = case()
    elem_ok, ratio, row, row_ok = verdict(
        dkdv_replay(*args, fault="ds-rounded-p"), want)
    assert elem_ok, ratio
    assert 0.5 < row < 2, row
