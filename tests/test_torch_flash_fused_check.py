"""The fused flash backward (``csrc/flash_bwd.cu`` ``flash_bwd_fused_kernel``)
replayed on the CPU, with planted faults that its checks must catch.

The kernel cannot run here, so three parts of its design are modelled in
PyTorch with the constants and expressions read from the source:

- the arithmetic of its dQ half at the training path's head shape (S 1024,
  D 128, causal): work items of 128 keys walk 64-row q tiles from the last
  down to the one that holds their first key; the D-sums K·qsᵀ and V·dOᵀ
  are taken in 16-wide k-steps as its wgmma instructions take them; P =
  exp2(K·qsᵀ − l2) in fp32, masked where a query precedes its key; dS =
  P∘(V·dOᵀ − dd) rounded to bf16; the item's dq tile dS·K summed over its
  128 keys in 16-key k-steps; the tiles added into the one accumulator of
  each reference k block ``[n_j, BH, S, D]`` in key order (the first item
  writes), and dq formed by the last item of each q tile as
  bf16(bf16(acc)·D^-0.5).  That replay must pass the check that
  chip_smoke.py and tests/test_torch_cuda.py apply to the kernel
  (elementwise within ``flash.ELEM_TOL``, each head-row within
  ``flash.ROW_TOL["dq"]``); with a planted fault it must not;
- the persistent walk: an event-driven simulation of blocks that take
  items from one counter and add each q tile behind its flag, on 132, 7
  and 1 virtual SMs, must finish every item (no deadlock) and give every
  q tile its items exactly once, in key order; a counter that hands out a
  later key tile before an earlier one must deadlock, and a skipped item
  must leave a tile short;
- the one shared-memory copy of bf16(dS): each consumer stores its dSᵀ
  fragments (keys as rows, queries contiguous, 128B-swizzled), and dq's
  wgmma reads that tile as an MN-major A operand (the transpose bit for
  A); the replay reads it through the descriptor and must get dS back,
  and a swizzle one row off must not.
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
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


KEYS, QROWS, ROW = constant("kItemKeys"), constant("kQRows"), \
    constant("kRowBytes")
GROUP = constant("kGroup")
BH, S, D = 4, 1024, 128
SMS = 132


def test_the_replay_reads_the_sources_it_models():
    """The expressions the replay models, as the source writes them."""
    for line in (
            "const int g0 = w / (kGroup * p.n_kt) * kGroup, gs = min(kGroup, "
            "p.BH - g0);\n"
            "  const int bh = g0 + (w - g0 * p.n_kt) % gs, kt = (w - g0 * "
            "p.n_kt) / gs;",
            "return {bh, kt, CAUSAL ? kt * kItemKeys / kQRows : 0};",
            "const int w = atomicAdd(p.next, 1);",
            "for (int i = p.n_qt - 1; i >= it.first; --i, ++t) {",
            "const int j = it.kt / p.per_j, pos = it.kt - j * p.per_j;",
            "CAUSAL ? min(j_last, (i * kQRows + kQRows - 1) / kItemKeys)",
            "const bool form = p.direct && it.kt == last;",
            "for (int spin = 0; ld_acquire_gpu(flag) != pos; ++spin)",
            "if (pos == 0)\n"
            "                tma_store(&tm_acc, sq + pc * kPieceBytes, col, "
            "i * kQRows, z);\n"
            "              else\n"
            "                tma_reduce_add(&tm_acc, sq + pc * kPieceBytes, "
            "col,",
            "st_release_gpu(flag, pos + 1);",
            "const int direct = lay.n_j == 1;",
            "return __bfloat162float(__float2bfloat16_rn(y)) * p.scale;",
            "keep = q0 + qi < p.S && key < p.Sk && (!CAUSAL || q0 + qi >= key);",
            "ds + row * kRowBytes + ((chunk ^ (row & 7)) << 4) +",
            "const int row = 64 * c + row_l + 8 * (e & 1);",
            "const int chunk = 2 * kk + (e >> 1);",
            "wgmma_ss_n64<1, 1>(",
            "dq, desc_sw128(ds_addr + kk * 16 * kRowBytes, L::kDSBytes,",
            "pa[kk][e] = flash::pack_bf16(dp[8 * kk + 2 * e], "
            "dp[8 * kk + 2 * e + 1]);"):
        assert line in SRC, line
    # the release follows the add's completion: a release before the add
    # lands would be a lost update
    body = SRC[SRC.index("const bool form = p.direct"):]
    assert body.index("tma_store_wait_all();") \
        < body.index("fence_proxy_async_global();\n            if (form)") \
        < body.index("st_release_gpu(flag, pos + 1);")
    assert (KEYS, QROWS, ROW) == (128, 64, 128)
    assert tf.FUSED_Q_ROWS == QROWS and tf.KV_BLOCK % KEYS == 0


# --------------------------------------------------------------------------
# the arithmetic of dQ
# --------------------------------------------------------------------------

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


def ksteps(a, b, width: int):
    """``a·bᵀ`` over the last dim summed as wgmma sums it: one fp32 partial
    per ``width``-wide k-step, added in order."""
    acc = torch.zeros(a.shape[:2] + b.shape[1:2])
    for c in range(0, a.shape[-1], width):
        acc += a[..., c:c + width] @ b[..., c:c + width].transpose(1, 2)
    return acc


def dq_replay(qs, k, v, do, l2, dd, fault=None):
    """The fused kernel's dQ arithmetic, optionally with a planted
    ``fault``:

    - ``skipped-item``: the item of key tile 3 never runs;
    - ``release-before-add``: each item releases its flag before its add
      lands, so the next item adds to the accumulator as it was before it
      (a lost update);
    - ``unmasked-diagonal``: the causal mask is not applied, so dS reaches
      keys after the query;
    - ``no-scale``: dq is formed without the D^-0.5 factor.
    """
    n_kt, n_qt = S // KEYS, S // QROWS
    per_j = tf.KV_BLOCK // KEYS
    n_j = -(-n_kt // per_j)
    acc = torch.full((n_j, BH, S, D), float("nan"))
    before = torch.full_like(acc, float("nan"))   # acc before the last add
    dq = torch.full((BH, S, D), float("nan"))
    qsf, dof = qs.float(), do.float()
    l2r, ddr = l2[..., 0], dd[..., 0]
    for kt in range(n_kt):                      # the flags' order
        if fault == "skipped-item" and kt == 3:
            continue
        k0 = kt * KEYS
        kb, vb = k[:, k0:k0 + KEYS].float(), v[:, k0:k0 + KEYS].float()
        keys = torch.arange(k0, k0 + KEYS)[:, None]
        j, pos = divmod(kt, per_j)
        j_last = min((j + 1) * per_j, n_kt) - 1
        for i in range(n_qt - 1, kt * KEYS // QROWS - 1, -1):
            q0 = i * QROWS
            rows = torch.arange(q0, q0 + QROWS)[None, :]
            keep = rows >= keys
            if fault == "unmasked-diagonal":
                keep = torch.ones_like(keep)
            st = ksteps(kb, qsf[:, q0:q0 + QROWS], 16)       # [BH, keys, q]
            p = torch.where(keep, torch.exp2(st - l2r[:, None, q0:q0 + QROWS]),
                            0.0)
            dpt = ksteps(vb, dof[:, q0:q0 + QROWS], 16)
            dst = (p * (dpt - ddr[:, None, q0:q0 + QROWS])).bfloat16().float()
            tile = torch.zeros((BH, QROWS, D))
            for kk in range(0, KEYS, 16):               # dq's 8 k-steps
                tile += dst[:, kk:kk + 16].transpose(1, 2) @ kb[:, kk:kk + 16]
            rs = slice(q0, q0 + QROWS)
            old = acc[j, :, rs].clone()
            if pos == 0:
                total = tile
            elif fault == "release-before-add" and pos > 1:
                total = before[j, :, rs] + tile   # read before the last add
            else:
                total = old + tile
            before[j, :, rs], acc[j, :, rs] = old, total
            if kt == min(j_last, (q0 + QROWS - 1) // KEYS) and n_j == 1:
                scale = 1.0 if fault == "no-scale" else D ** -0.5
                dq[:, rs] = total.bfloat16().float() * scale
    if n_j > 1:
        return tf._finish_dq(acc.bfloat16().float(), D)
    return dq.bfloat16()


def verdict(got, want):
    """(worst elementwise share of the tolerance, worst head-row error as
    a share of ROW_TOL["dq"]); an element never written (NaN) counts as
    infinitely wrong."""
    inf = float("inf")
    diff = (got.float() - want.float()).abs().nan_to_num(nan=inf)
    ratio = float((diff / (tf.ELEM_TOL + tf.ELEM_TOL
                           * want.float().abs())).max())
    row = float(tf.row_rel_err(got, want).nan_to_num(nan=inf).max()) \
        / tf.ROW_TOL["dq"]
    return ratio, row


def test_clean_replay_passes_the_check():
    args, want = case()
    ratio, row = verdict(dq_replay(*args), want)
    assert ratio < 0.5 and row < 0.25, (ratio, row)


@pytest.mark.parametrize("fault", ["skipped-item", "release-before-add",
                                   "unmasked-diagonal", "no-scale"])
def test_planted_fault_fails_the_check(fault):
    args, want = case()
    ratio, row = verdict(dq_replay(*args, fault=fault), want)
    assert ratio > 1 and row > 5, (fault, ratio, row)


# --------------------------------------------------------------------------
# the persistent walk and its flags
# --------------------------------------------------------------------------

def item_at(w: int, bh: int, n_kt: int):
    """``item_at`` of the source: head-rows in groups of GROUP, the key
    tile outer and the head-row inner within a group."""
    g0 = w // (GROUP * n_kt) * GROUP
    gs = min(GROUP, bh - g0)
    r = w - g0 * n_kt
    return g0 + r % gs, r // gs


def walk(sms: int, bh: int, s: int, kv_block: int, fault=None):
    """Blocks on ``sms`` virtual SMs take items (head-row, key tile) from
    one counter, in ``item_at`` order, when idle and add their q tiles,
    from the last down, each
    behind its flag (wait until the flag equals the item's position in
    key order within its k block, add, release to position + 1).  Each
    step every block takes one action (take an item, or add a tile); a
    step in which no block can act while items remain is a deadlock.
    Returns (finished, the log of adds per (j, head-row, q tile)).

    ``later-first``: the counter hands out each head-row's key tiles in
    descending order; ``skipped-item``: it skips one item."""
    n_kt, n_qt = -(-s // KEYS), -(-s // QROWS)
    per_j = kv_block // KEYS
    order = [item_at(w, bh, n_kt) for w in range(bh * n_kt)]
    assert sorted(order) == [(b, kt) for b in range(bh)
                             for kt in range(n_kt)]
    if fault == "later-first":
        order = [(b, n_kt - 1 - kt) for b, kt in order]
    if fault == "skipped-item":
        order.remove((0, 1))
    flags, log = {}, {}
    blocks = [None] * sms          # [item, tiles left (descending)]
    nxt = 0
    while True:
        moved = False
        for n, blk in enumerate(blocks):
            if blk is None or not blk[1]:
                if nxt < len(order):
                    b, kt = order[nxt]
                    nxt += 1
                    first = kt * KEYS // QROWS         # causal
                    blocks[n] = [(b, kt), list(range(n_qt - 1, first - 1, -1))]
                    moved = True
                else:
                    blocks[n] = None
                continue
            (b, kt), tiles = blk
            j, pos = divmod(kt, per_j)
            key = (j, b, tiles[0])
            if flags.get(key, 0) == pos:
                log.setdefault(key, []).append(kt)
                flags[key] = pos + 1
                tiles.pop(0)
                moved = True
        if all(blk is None for blk in blocks) and nxt >= len(order):
            return True, log
        if not moved:
            return False, log


def tiles_in_key_order(log: dict, bh: int, s: int, kv_block: int) -> bool:
    """Every q tile got each item of each k block that reaches it exactly
    once, in key order (causal: key tile kt reaches q tile i while
    128·kt ≤ 64·i + 63)."""
    n_kt, n_qt = -(-s // KEYS), -(-s // QROWS)
    per_j = kv_block // KEYS
    want = {}
    for b in range(bh):
        for i in range(n_qt):
            for kt in range(min(n_kt, (i * QROWS + QROWS - 1) // KEYS + 1)):
                want.setdefault((kt // per_j, b, i), []).append(kt)
    return log == want


# (SMs, head-rows, S, kv_block): the flagship on the card; few SMs; one
# SM; a ragged S over two k blocks
WALKS = [(SMS, 256, 1024, 1024), (7, 16, 1024, 1024), (1, 4, 1024, 1024),
         (7, 5, 2500, 1024)]


@pytest.mark.parametrize("case", WALKS, ids=str)
def test_walk_finishes_and_orders_every_tile(case):
    sms, bh, s, kv_block = case
    done, log = walk(sms, bh, s, kv_block)
    assert done
    assert tiles_in_key_order(log, bh, s, kv_block)


@pytest.mark.parametrize("sms", [7, 1])
def test_planted_later_key_tile_first_deadlocks(sms):
    done, _ = walk(sms, 4, 1024, 1024, fault="later-first")
    assert not done


def test_planted_skipped_item_leaves_a_tile_short():
    done, log = walk(SMS, 16, 1024, 1024, fault="skipped-item")
    assert not (done and tiles_in_key_order(log, 16, 1024, 1024))


# --------------------------------------------------------------------------
# bf16(dS) in shared memory: the consumers' stores, dq's MN-major A reads
# --------------------------------------------------------------------------

def swizzle(addr):
    """Byte address → where the 128B swizzle puts it (bits 4-6 XOR 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def store_dst(dst, phase: int = 0):
    """The consumers' stores of dSᵀ [128 keys, 64 queries] (one bf16 per
    2-byte slot): register pa[kk][e] of consumer c, warp w, lane 4g + t
    holds (key 64c + 16w + g + 8(e & 1), queries 16kk + 8(e >> 1) + 2t,
    +1), stored at row·128 + ((chunk ^ (row mod 8)) << 4) + 4t, chunk =
    2kk + (e >> 1); ``phase`` plants a swizzle off by that many rows."""
    smem = torch.full((KEYS * ROW // 2,), float("nan"))
    for c in range(2):
        for w in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for kk in range(4):
                    for e in range(4):
                        row = 64 * c + 16 * w + g + 8 * (e & 1)
                        chunk = 2 * kk + (e >> 1)
                        col = 8 * chunk + 2 * t
                        addr = row * ROW + ((chunk ^ ((row + phase) & 7))
                                            << 4) + 2 * t * 2
                        smem[addr // 2] = dst[row, col]
                        smem[addr // 2 + 1] = dst[row, col + 1]
    return smem


def read_a_mnmajor(smem, start: int, sbo: int):
    """The 64 x 16 A operand (rows m = queries, k = keys) an MN-major
    descriptor names: element (m, k) at start + (k / 8)·SBO + (k mod
    8)·128 + 2m (M is one 64-wide swizzle span, so LBO is not used),
    swizzled."""
    m = torch.arange(64)[:, None]
    k = torch.arange(16)[None, :]
    return smem[swizzle(start + (k // 8) * sbo + (k % 8) * ROW + 2 * m) // 2]


@pytest.mark.parametrize("phase", [0, 1], ids=["clean", "swizzle-phase"])
def test_ds_tile_reads_back_as_dq_a_operand(phase):
    """dq's k-step kk reads keys 16kk .. 16kk + 15 at ds + kk·16·128 with
    SBO 1024 (as the source's descriptor gives them) and must get dS =
    (dSᵀ)ᵀ exactly; a store one swizzle row off must not."""
    g = torch.Generator().manual_seed(3)
    dst = torch.randint(-50, 50, (KEYS, 64), generator=g).float()
    smem = store_dst(dst, phase)
    got = torch.cat([read_a_mnmajor(smem, kk * 16 * ROW, 1024)
                     for kk in range(KEYS // 16)], dim=1)
    assert torch.equal(got, dst.T) == (phase == 0)
