"""The check that holds the fused flash backward's dQ to its plain version
(elementwise within ``flash.ELEM_TOL`` and each head-row within
``flash.ROW_TOL["dq"]`` by ``flash.row_rel_err``, as chip_smoke.py and
tests/test_torch_cuda.py apply it) has teeth.

The kernel cannot run here, so the arithmetic of its dQ half is replayed
in PyTorch at the training path's head shape (S 1024, D 128, causal): one
block per 64-key tile walks 32-row q tiles from the one that holds its
first key down to S; the D-sums k·qsᵀ and V·dOᵀ are taken in 16-wide
k-steps as its mma instructions take them; P = exp2(k·qsᵀ − l2) in fp32,
masked where a query precedes its key; dS = P∘(V·dOᵀ − dd) is rounded to
bf16, and the tile's dS·K (summed over the block's 64 keys in fp32) is
stored into the tile's own slot of one flat fp32 scratch, laid out as the
kernel lays it out (slot t holds rows [64·t, S), ``flash.dq_slot_rows``
rows a head-row in all).  The second pass sums, for each reference k
block (KV_BLOCK keys: one at S = 1024), its tiles' slots in key order in
fp32, and dq is then formed as the wrapper forms it:
bf16(Σ bf16(partial) · D^-0.5).  No two tiles write one element and the
sum runs in one order, so dq is the same from run to run.  That replay
must pass the check; the same replay with a structural fault must not.
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
    forward, and the plain fused backward's dq."""
    r = np.random.default_rng(10)

    def bf16(shape):
        return torch.from_numpy(
            r.standard_normal(shape).astype(np.float32)).bfloat16()
    q, k, v, do = (bf16((BH, S, D)) for _ in range(4))
    out, l2 = tf.flash_attn_fwd_ref(q, k, v)
    qs = tf._prescale(q)
    dd = (do.float() * out.float()).sum(-1, keepdim=True)
    want = tf.flash_bwd_fused_ref(qs, k, v, do, l2, dd)[0]
    return (qs, k, v, do, l2, dd), want


def ksteps(a, b):
    """``a·bᵀ`` over D summed as the kernel's mma instructions sum it: one
    fp32 partial per 16-wide k-step, added in order."""
    acc = torch.zeros(a.shape[:2] + b.shape[1:2])
    for c in range(0, D, 16):
        acc += a[..., c:c + 16] @ b[..., c:c + 16].transpose(1, 2)
    return acc


def slot_base(t: int) -> int:
    """Where tile t's slot starts in the scratch (``slot_base`` of
    csrc/flash_bwd.cu under the causal mask), in elements."""
    return (t * S - 32 * t * (t - 1)) * BH * D


def dq_replay(qs, k, v, do, l2, dd, fault=None):
    """The fused kernel's dQ arithmetic and the wrapper's finish,
    optionally with a planted ``fault``:

    - ``skip-tile``: q tile 30 (rows 960-991) is dropped by every block;
    - ``unmasked-diagonal``: the causal mask is not applied on the tiles
      that straddle the diagonal, so dS reaches keys after the query;
    - ``no-scale``: dq is rounded without the D^-0.5 factor;
    - ``overlapping-slots``: the slots start 64 rows too close together
      (32·t² for 32·t·(t − 1)), so each tile overwrites its neighbour's
      first rows.
    """
    scratch = torch.full((tf.dq_slot_rows(S, S, True) * BH * D,),
                         float("nan"))
    qsf, dof = qs.float(), do.float()
    l2r, ddr = l2[..., 0], dd[..., 0]

    def slot(t):
        base = slot_base(t)
        if fault == "overlapping-slots":
            base = (t * S - 32 * t * t) * BH * D
        return scratch[base:base + BH * (S - BK * t) * D].view(
            BH, S - BK * t, D)
    for k0 in range(0, S, BK):
        kb, vb = k[:, k0:k0 + BK].float(), v[:, k0:k0 + BK].float()
        keys = torch.arange(k0, k0 + BK)[:, None]
        mine = slot(k0 // BK)
        for q0 in range(k0, S, BQ2):
            qt, dot = qsf[:, q0:q0 + BQ2], dof[:, q0:q0 + BQ2]
            rows = torch.arange(q0, q0 + BQ2)[None, :]
            keep = rows >= keys
            if fault == "unmasked-diagonal":
                keep = torch.ones_like(keep)
            p = torch.where(keep, torch.exp2(
                ksteps(kb, qt) - l2r[:, None, q0:q0 + BQ2]), 0.0)
            ds = (p * (ksteps(vb, dot) - ddr[:, None, q0:q0 + BQ2])) \
                .bfloat16().float()                       # [BH, keys, q]
            out = ds.transpose(1, 2) @ kb
            if fault == "skip-tile" and q0 == 30 * BQ2:
                out = torch.zeros_like(out)
            mine[:, q0 - k0:q0 - k0 + BQ2] = out
    per_j = tf.KV_BLOCK // BK
    n_t = S // BK
    parts = []
    for t0 in range(0, n_t, per_j):
        acc = torch.zeros((BH, S, D))
        for t in range(t0, min(t0 + per_j, n_t)):
            acc[:, BK * t:] += slot(t)
        parts.append(acc)
    parts = torch.stack(parts).bfloat16().float()
    if fault == "no-scale":
        return parts.sum(0).bfloat16()
    return tf._finish_dq(parts, D)


def verdict(got, want):
    """(worst elementwise share of the tolerance, worst head-row error as
    a share of ROW_TOL["dq"])."""
    diff = (got.float() - want.float()).abs()
    ratio = float((diff / (tf.ELEM_TOL + tf.ELEM_TOL
                           * want.float().abs())).max())
    row = float(tf.row_rel_err(got, want).max()) / tf.ROW_TOL["dq"]
    return ratio, row


def test_clean_replay_passes_the_check():
    args, want = case()
    ratio, row = verdict(dq_replay(*args), want)
    assert ratio < 0.5 and row < 0.25, (ratio, row)


@pytest.mark.parametrize("fault", ["skip-tile", "unmasked-diagonal",
                                   "no-scale", "overlapping-slots"])
def test_planted_fault_fails_the_check(fault):
    args, want = case()
    ratio, row = verdict(dq_replay(*args, fault=fault), want)
    assert ratio > 1 and row > 5, (fault, ratio, row)
