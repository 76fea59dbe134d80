"""The checks that hold the split flash backward's two kernels to their
plain versions (elementwise within ``flash.ELEM_TOL`` and each head-row
within ``flash.ROW_TOL`` by ``flash.row_rel_err``, as chip_smoke.py and
tests/test_torch_cuda.py apply them) have teeth, for each kernel's own
order of work.

Neither kernel can run here, so each one's arithmetic is replayed in
PyTorch with the tile constants and expressions read from
``csrc/flash_bwd.cu``:

- the dQ kernel (``flash_bwd_dq_kernel``): 128-row q tiles, each two
  64-row halves (the two consumer warpgroups), walking 64-key tiles of K
  and V that TMA zero-fills past Sk; under the causal mask a half stops
  after the tile that holds its last row.  qs·Kᵀ and dout·Vᵀ are summed
  over D in 16-wide k-steps in fp32; P = exp2(S − l2), masked where a key
  follows the row (causal) or lies past Sk; dS = bf16(P∘(dP − dd)) from
  the fp32 P; dq += dS·K in 16-key k-steps, in key order, in fp32; dq =
  bf16(acc · D^-0.5) once;
- the dK/dV kernel (``flash_bwd_fused_kernel<D, CAUSAL, false>``):
  128-key items walking 64-row q tiles of qs and dout from the last down
  to the one that holds the item's first key under the causal mask (all
  of them otherwise), rows past S zero-filled and their l2, dd 0; Sᵀ =
  K·qsᵀ and dPᵀ = V·doutᵀ in 16-wide k-steps over D; Pᵀ = exp2(Sᵀ − l2)
  masked; dV += bf16(Pᵀ)·dout and dK += bf16(dSᵀ)·qs in 16-query k-steps,
  in fp32; dk = bf16(acc / log2e) and dv = bf16(acc) once;
- the dK/dV kernel's static walk: pairs of one head-row's items, the
  longest and the shortest left under the causal mask, round robin over
  the blocks.

Each replay must pass the check at the training path's head shape (S
1024, D 128, causal) and at a ragged non-causal GQA shape; with a planted
fault it must fail.

The replays are cleaner than the kernels: the tensor cores do not add in
strict fp32, and the cancellation in dP − dd turns that into bf16 flips
of dS, so on an H100 80GB HBM3 at 700 W the kernels score several times
the replays' head-row errors (PERF.md §6).
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_dra_torch.workloads import flash as tf

SRC = (Path(__file__).resolve().parent.parent / "tpu_dra_torch" / "csrc"
       / "flash_bwd.cu").read_text()


def constant(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", SRC)
    assert len(set(found)) == 1, (name, found)
    return int(found[0])


# the dQ kernel's q tile and K/V tile; the dK/dV kernel's item and q tile
BQ, BK = constant("kBQ"), constant("kBK")
KEYS, QROWS = constant("kItemKeys"), constant("kQRows")
HALF, KSTEP = 64, 16
SMS = 132


def test_the_replay_reads_the_sources_it_models():
    """The expressions the replays model, as the source writes them."""
    for line in (
            # the dQ kernel
            "const int n_all = key_tiles<CAUSAL>(q0 + kBQ, p.Sk);",
            "const int n_mine = key_tiles<CAUSAL>(q_first + 64, p.Sk);",
            "const int kv_end = CAUSAL ? min(Sk, row_end) : Sk;",
            "const bool masked = k0 + kBK > p.Sk || (CAUSAL && k0 + kBK - 1 "
            "> q_first);",
            "keep = CAUSAL ? key <= row0 + 8 * h : key < p.Sk;",
            "s[x] = keep ? flash::exp2_ftz(s[x] - l2r[h]) : 0.f;",
            "pa[kk][e] = flash::pack_bf16(s[x] * (dp[x] - ddr[e & 1]),",
            "for (int kk = 0; kk < kBK / 16; ++kk)\n"
            "    wgmma_rs<D, 1>(dq, pa[kk],",
            "dq[4 * jj + 2 * h] * p.scale, dq[4 * jj + 2 * h + 1] * p.scale);",
            "l2r[h] = row < p.S ? p.l2[off + row] : 0.f;",
            "(err = tensor_map_bf16(&tm_k, k, BHkv, Sk, D, kBK)) != "
            "cudaSuccess ||",
            # the dK/dV kernel
            "auto kernel = flash_bwd_fused_kernel<D, CAUSAL, false>;",
            "const int bh = w % p.BH, kt = w / p.BH;",
            "return {bh, kt, CAUSAL ? kt * kItemKeys / kQRows : 0};",
            "produce(n++, pr * p.BH + bh);",
            "if (pr != p.n_kt - 1 - pr) {",
            "produce(n++, (p.n_kt - 1 - pr) * p.BH + bh);",
            "grid_blocks(BH * ((n_kt + 1) / 2), &blocks)",
            "for (int i = p.n_qt - 1; i >= it.first; --i, ++t) {",
            "keep = q0 + qi < p.S && key < p.Sk && (!CAUSAL || q0 + qi >= key);",
            "const float e = s[x] - sl2[qi];",
            "s[x] = keep ? (DQ ? exp2f(e) : flash::exp2_ftz(e)) : 0.f;",
            "stat[r] = row < p.S ? p.l2[off + row] : 0.f;",
            "dp[x] = s[x] * (dp[x] - sdd[8 * (x >> 2) + col_t + (x & 1)]);",
            "dk[4 * jj + 2 * h] * kInvLog2e, dk[4 * jj + 2 * h + 1] * "
            "kInvLog2e);",
            "(err = tensor_map_bf16(&tm_q, qs, BH, S, D, kQRows)) != "
            "cudaSuccess ||"):
        assert line in SRC, line
    # S and dP over D in 16-wide k-steps, in both kernels
    assert SRC.count("for (int kk = 0; kk < D / 16; ++kk)") >= 3
    # dS is rounded after the fp32 P, in the dQ kernel before its product
    body = SRC[SRC.index("template <int D, bool CAUSAL>\n__device__ "
                         "__forceinline__ void consume_tile"):]
    assert body.index("s[x] = keep ? flash::exp2_ftz") < body.index(
        "flash::pack_bf16(s[x] * (dp[x]") < body.index(
        "issue_dq<D>(dq, pa, k_at(n_mine - 1));")
    assert (BQ, BK, KEYS, QROWS) == (128, 64, 128, 64)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

# (BH, BHkv, S, Sk, causal) at D 128: the training path's head shape, and
# a non-causal GQA (g = 2) shape whose q rows (S 1000) and keys (Sk 936)
# both end inside a tile of either kernel
CASES = {"causal-1024": (4, 4, 1024, 1024, True),
         "full-ragged": (4, 2, 1000, 936, False)}
D = 128


@functools.lru_cache(maxsize=None)
def case(name: str):
    """Inputs from a numpy seed, out/l2 from the plain forward, and the
    plain dQ and dK/dV."""
    bh, bhkv, s, sk, causal = CASES[name]
    r = np.random.default_rng(9)

    def bf16(n, length):
        return torch.from_numpy(
            r.standard_normal((n, length, D)).astype(np.float32)).bfloat16()
    q, k, v, do = bf16(bh, s), bf16(bhkv, sk), bf16(bhkv, sk), bf16(bh, s)
    out, l2 = tf.flash_attn_fwd_ref(q, k, v, causal)
    qs = tf._prescale(q)
    dd = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (qs, k, v, do, l2, dd, causal)
    return args, {"dq": (tf.flash_bwd_dq_ref(*args),),
                  "dkdv": tf.flash_bwd_dkdv_ref(*args)}


def ksteps(a, b):
    """``a·bᵀ`` over the last dim summed as the kernels' wgmma sums it: one
    fp32 partial per 16-wide k-step, added in order."""
    acc = torch.zeros(a.shape[:2] + b.shape[1:2])
    for c in range(0, a.shape[-1], KSTEP):
        acc += a[..., c:c + KSTEP] @ b[..., c:c + KSTEP].transpose(1, 2)
    return acc


def kmajor_sum(a, b):
    """``a·b`` over a's last dim (b's rows) in 16-wide k-steps, in order."""
    acc = torch.zeros(a.shape[:2] + b.shape[2:])
    for c in range(0, a.shape[-1], KSTEP):
        acc += a[..., c:c + KSTEP] @ b[:, c:c + KSTEP]
    return acc


def padded(t, rows: int, nxt: bool = False):
    """``t [n, L, D]`` fp32 to ``rows`` rows: zeros past L, as TMA fills a
    3-D map's box; with ``nxt`` the next matrix's first rows instead (the
    last matrix's zeros), as a 2-D map over [n·L, D] would read."""
    n, length, d = t.shape
    out = torch.zeros((n, rows, d))
    out[:, :length] = t.float()
    if nxt:
        tail = rows - length
        out[:-1, length:] = t[1:, :tail].float()
    return out


# --------------------------------------------------------------------------
# the dQ kernel
# --------------------------------------------------------------------------

DQ_FAULTS = {
    # each consumer stops one k tile short under the mask: its diagonal
    # tile never reaches dq
    "skip-diagonal": "causal-1024",
    # the mask drops the diagonal (key < row instead of key <= row)
    "strict-mask": "causal-1024",
    # the accumulator is scaled by D^-0.5 at every k tile, as the forward
    # rescales its own, instead of once at the end
    "scale-per-tile": "causal-1024",
    # the ragged key tail is not masked, and is read from the next kv
    # head's first keys (a 2-D map over [BHkv·Sk, D])
    "tail-from-next-head": "full-ragged",
}


def dq_replay(qs, k, v, do, l2, dd, causal, fault=None):
    """The dQ kernel's arithmetic, optionally with a planted ``fault``
    (``DQ_FAULTS``, or ``ds-rounded-p``: dS from bf16(P))."""
    bh, s, d = qs.shape
    bhkv, sk, _ = k.shape
    kvh = torch.arange(bh) // (bh // bhkv)
    s_pad, sk_pad = -(-s // BQ) * BQ, -(-sk // BK) * BK
    nxt = fault == "tail-from-next-head"
    qp, dop = padded(qs, s_pad), padded(do, s_pad)
    kp, vp = padded(k, sk_pad, nxt)[kvh], padded(v, sk_pad, nxt)[kvh]
    l2p = padded(l2, s_pad)[..., 0]
    ddp = padded(dd, s_pad)[..., 0]
    scale = d ** -0.5
    dq = torch.zeros((bh, s_pad, d))
    for q_first in range(0, s_pad, HALF):        # one consumer's 64 rows
        rs = slice(q_first, q_first + HALF)
        rows = torch.arange(q_first, q_first + HALF)[:, None]
        n_mine = -(-(min(sk, q_first + HALF) if causal else sk) // BK)
        if fault == "skip-diagonal":
            n_mine -= 1
        acc = torch.zeros((bh, HALF, d))
        for j in range(n_mine):
            k0 = j * BK
            kb, vb = kp[:, k0:k0 + BK], vp[:, k0:k0 + BK]
            st = ksteps(qp[:, rs], kb)
            dpt = ksteps(dop[:, rs], vb)
            keys = torch.arange(k0, k0 + BK)[None, :]
            if causal:
                keep = keys < rows if fault == "strict-mask" else keys <= rows
            else:
                keep = torch.ones_like(keys, dtype=torch.bool) if nxt \
                    else keys < sk
            p = torch.where(keep, torch.exp2(st - l2p[:, rs, None]), 0.0)
            pf = p.bfloat16().float() if fault == "ds-rounded-p" else p
            ds = (pf * (dpt - ddp[:, rs, None])).bfloat16().float()
            if fault == "scale-per-tile":
                acc = acc * scale
            acc += kmajor_sum(ds, kb)
        dq[:, rs] = acc * scale
    return (dq[:, :s].bfloat16(),)


# --------------------------------------------------------------------------
# the dK/dV kernel
# --------------------------------------------------------------------------

DKDV_FAULTS = {
    # an item stops one q tile short: the tile that holds its first key
    # (its diagonal) never reaches dk, dv
    "stop-early": "causal-1024",
    # the mask drops the diagonal (query > key instead of query >= key)
    "strict-mask": "causal-1024",
    # l2 and dd from the q tile walked before (a stage index off by one)
    "stale-stats": "causal-1024",
    # q rows past S are not masked, and are read from the next head-row's
    # first rows (a 2-D map over [BH·S, D])
    "tail-from-next-head": "full-ragged",
}


def dkdv_replay(qs, k, v, do, l2, dd, causal, fault=None):
    """The dK/dV kernel's arithmetic, optionally with a planted ``fault``
    (``DKDV_FAULTS``, or ``ds-rounded-p``: dS from bf16(P))."""
    bh, s, d = qs.shape
    bhkv, sk, _ = k.shape
    kvh = torch.arange(bh) // (bh // bhkv)
    n_kt, n_qt = -(-sk // KEYS), -(-s // QROWS)
    nxt = fault == "tail-from-next-head"
    qp, dop = padded(qs, n_qt * QROWS, nxt), padded(do, n_qt * QROWS, nxt)
    kp = padded(k, n_kt * KEYS)[kvh]
    vp = padded(v, n_kt * KEYS)[kvh]
    l2p = padded(l2, n_qt * QROWS)[..., 0]        # the stat warp's zeros
    ddp = padded(dd, n_qt * QROWS)[..., 0]
    dk = torch.zeros((bh, n_kt * KEYS, d))
    dv = torch.zeros_like(dk)
    for kt in range(n_kt):
        k0 = kt * KEYS
        ks = slice(k0, k0 + KEYS)
        keys = torch.arange(k0, k0 + KEYS)[:, None]
        first = kt * KEYS // QROWS if causal else 0
        if fault == "stop-early":
            first += 1
        for i in range(n_qt - 1, first - 1, -1):
            q0 = i * QROWS
            qrs = slice(q0, q0 + QROWS)
            srs = qrs
            if fault == "stale-stats" and i + 1 < n_qt:
                srs = slice(q0 + QROWS, q0 + 2 * QROWS)
            qi = torch.arange(q0, q0 + QROWS)[None, :]
            keep = (keys < sk) & (torch.ones_like(qi, dtype=torch.bool)
                                  if nxt else qi < s)
            if causal:
                keep &= qi > keys if fault == "strict-mask" else qi >= keys
            st = ksteps(kp[:, ks], qp[:, qrs])             # [BH, keys, q]
            p = torch.where(keep, torch.exp2(st - l2p[:, None, srs]), 0.0)
            dv[:, ks] += kmajor_sum(p.bfloat16().float(), dop[:, qrs])
            dpt = ksteps(vp[:, ks], dop[:, qrs])
            pf = p.bfloat16().float() if fault == "ds-rounded-p" else p
            ds = (pf * (dpt - ddp[:, None, srs])).bfloat16().float()
            dk[:, ks] += kmajor_sum(ds, qp[:, qrs])
    return ((dk[:, :sk] * (1.0 / tf._LOG2E)).bfloat16(),
            dv[:, :sk].bfloat16())


REPLAYS = {"dq": (dq_replay, ("dq",)), "dkdv": (dkdv_replay, ("dk", "dv"))}


def verdict(kernel: str, name: str, fault=None):
    """(elementwise ok, worst elementwise share of the tolerance, worst
    head-row error as a share of its ROW_TOL) of ``kernel``'s replay on
    case ``name`` against its plain version."""
    args, want = case(name)
    replay, outs = REPLAYS[kernel]
    ratio, row = 0.0, 0.0
    for g, w, out in zip(replay(*args, fault=fault), want[kernel], outs):
        diff = (g.float() - w.float()).abs()
        ratio = max(ratio, float((diff / (tf.ELEM_TOL + tf.ELEM_TOL
                                          * w.float().abs())).max()))
        row = max(row, float(tf.row_rel_err(g, w).max()) / tf.ROW_TOL[out])
    return ratio <= 1, ratio, row


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kernel", list(REPLAYS))
def test_clean_replay_passes_the_check(kernel, name):
    elem_ok, ratio, row = verdict(kernel, name)
    assert elem_ok and row <= 1, (ratio, row)
    assert ratio < 0.5 and row < 0.25, (ratio, row)


@pytest.mark.parametrize("kernel,fault", [
    *(("dq", f) for f in DQ_FAULTS), *(("dkdv", f) for f in DKDV_FAULTS)])
def test_planted_fault_fails_the_check(kernel, fault):
    name = (DQ_FAULTS if kernel == "dq" else DKDV_FAULTS)[fault]
    elem_ok, ratio, row = verdict(kernel, name, fault)
    # each fails the head-row check by a wide margin, and the elementwise
    # check too
    assert row > 5 and not elem_ok, (fault, ratio, row)


@pytest.mark.parametrize("kernel", list(REPLAYS))
def test_ds_rounding_point_sits_at_the_edge_of_the_check(kernel):
    """dS formed from bf16(P) instead of the fp32 P: the elementwise check
    cannot see it, and it lands near the head-row tolerance itself, so
    against a kernel's own noise the check may or may not catch it.  The
    kernel source pins this rounding point (flash_bwd.cu); no output check
    is relied on for it."""
    elem_ok, ratio, row = verdict(kernel, "causal-1024", "ds-rounded-p")
    assert elem_ok, ratio
    assert 0.5 < row < 2, row


# --------------------------------------------------------------------------
# the dK/dV kernel's static walk
# --------------------------------------------------------------------------

def kv_walk(sms: int, bh: int, s: int, causal: bool, fault=None):
    """Each block's items (head-row, key tile) in order: block b of G =
    min(SMs, pairs) takes pairs pw = b, b + G, …, pair pw = (head-row pw
    / n_pairs, pr = pw mod n_pairs) giving key tiles pr and n_kt − 1 − pr
    (one where they meet), each published as w = kt·BH + head-row and
    decoded as kv_item_at does.  ``middle-twice``: a pair whose two key
    tiles meet runs it twice."""
    n_kt = -(-s // KEYS)
    n_pairs = (n_kt + 1) // 2
    blocks = []
    for b in range(min(sms, bh * n_pairs)):
        items = []
        for pw in range(b, bh * n_pairs, min(sms, bh * n_pairs)):
            h, pr = divmod(pw, n_pairs)
            ws = [pr * bh + h]
            if pr != n_kt - 1 - pr or fault == "middle-twice":
                ws.append((n_kt - 1 - pr) * bh + h)
            items += [(w % bh, w // bh) for w in ws]
        blocks.append(items)
    return blocks


def q_tiles(s: int, kt: int, causal: bool) -> int:
    """q tiles item kt walks: from the last down to its first."""
    return -(-s // QROWS) - (kt * KEYS // QROWS if causal else 0)


# (SMs, head-rows, S, causal): the flagship, the GQA run and the DP×SP
# block on the card; an odd number of key tiles; one SM
WALKS = [(SMS, 256, 1024, True), (SMS, 64, 1024, True), (SMS, 256, 256, True),
         (7, 5, 1100, True), (1, 3, 1000, False)]


@pytest.mark.parametrize("walk", WALKS, ids=str)
def test_kv_walk_runs_every_item_once_and_balances_the_blocks(walk):
    sms, bh, s, causal = walk
    blocks = kv_walk(sms, bh, s, causal)
    got = sorted(it for items in blocks for it in items)
    assert got == [(h, kt) for h in range(bh) for kt in range(-(-s // KEYS))]
    work = [sum(q_tiles(s, kt, causal) for _, kt in items)
            for items in blocks]
    # a pair costs the same under the mask, so no block waits long for
    # the last: within 6% of the mean on the card's 132 SMs
    if sms == SMS:
        assert max(work) <= 1.06 * sum(work) / len(work), work


def test_planted_middle_item_twice_breaks_the_walk():
    blocks = kv_walk(7, 5, 1100, True, fault="middle-twice")
    got = sorted(it for items in blocks for it in items)
    assert got != [(h, kt) for h in range(5) for kt in range(9)]
