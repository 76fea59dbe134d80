#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dra_torch``) on one NVIDIA
GPU: builds its CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version, times it, then drives the
port's paths at full width: it serves the headline model through the
port's HTTP server (bf16 weights over pages; int8 weights over the slab
and over pages, plainly and speculatively with a distilled draft), runs
the tiled matmul's bench section, trains the flagship model through
``fit`` and through the fused training step, and trains it sharded over
a virtual mesh of 4 ranks on the card (DP×TP with the fused-collective
ring kernels, DP×SP with ring flash attention).

    python3 chip_smoke.py            # needs one CUDA card; no arguments

Phases (each prints as it goes; any failed check exits non-zero):
  1. build every kernel (one nvcc per source, all at once); print the
     build times, the ptxas register/spill lines and the card's name and
     power limit (nvidia-smi); fail if ptxas reports spill bytes for the
     flash forward kernel, the ring kernels, the split flash backward's
     two kernels, the RMSNorm-matmul's kernel or the paged attention's
     kernels (or serializes wgmma in any of them but the last);
  2. paged attention: kernel vs plain version at the serving path's shapes
     (B=32, H=8, Hkv=2, Dh=128, ps=64, MP=16), scrambled pages, -1 tails,
     lengths 0, 1, a page boundary, mid-page and the full MP*ps, and 4
     slots at the full MP*ps; bf16 pages within rtol/atol 0.05, int8 pages
     within 0.08 (the reference's own kernel-vs-oracle tolerances,
     tests/test_paged_kv.py), and every slot within paged_kv.SLOT_REL_TOL
     relative L2 error; a second call must give the same bits;
  3. time the paged kernel, the plain version and a library yardstick with
     CUDA events at one decode step of a full 160-page pool, and at 4 slots
     of 1024 tokens, by a loop of launches (the kernel and the library
     call also from CUDA graphs, where the host's launch cost drops out);
     at both, the kernel's share of its bound, its ratio to the library
     call and its time before the split-page redesign;
  4. serve: start serve() on port 0 with the full-width model (vocab
     32768, d_model 1024, 8 heads over 2 kv heads, 8 layers, d_ff 4096,
     rope, bf16 weights from a seed), the paged layout, slots 32, chunk
     8, page size 64, 160 pages; POST 8 concurrent greedy /generate
     requests and check each answer against the port's
     paged_greedy_decode on the card, and that the decode went through
     the kernel (launch counts);
  5. flash attention: the forward, dQ, dK/dV and fused-backward kernels
     vs their plain versions at the training path's shapes ([256, 1024,
     128] causal, and the GQA run's [64 over 16, 1024, 128]) and at S 1,
     63, 64, 65, 1000, causal and not, g 1 and 4, D 64 and 128; out, l2,
     dq, dk and dv each held elementwise and per head-row (relative L2
     over the row's [S, D]), tolerances flash.ELEM_TOL and flash.ROW_TOL;
     a second call of the fused backward, and of the split pair (dQ, dK/dV),
     must give bit-equal dq, dk, dv;
  6. time the four flash kernels, their wrappers and plain versions, and
     the library yardstick (scaled_dot_product_attention forward, and its
     backward for the backward kernels) with CUDA events at the path's
     shapes and at one rank's block of the DP×SP step ([256, 256, 128],
     causal and full); for the forward, the fused backward and the split
     pair, each one's share of its bound, its ratio to the SDPA call and
     its time before the TMA/wgmma redesign, and the fused backward's
     scratch bytes;
  7. matmul kernels: the tiled matmul at 4096^3, k 512, a rectangle and
     ragged tiles, the fused RMSNorm-matmul at the flagship's ln1 -> wqkv
     and ln2 -> w1 ([16384, 2048] @ [2048, 6144] and @ [2048, 8192]), m <
     256, K 64 and K 1024, each held elementwise and per output row
     (matmul.ELEM_TOL, matmul.ROW_TOL); their times beside bound, plain
     version and library yardstick (torch.matmul; for the fused kernel the
     unfused pair, two calls); then tpu_dra_torch.bench's
     section_pallas_matmul, the tiled matmul's path (launch counts), and
     the matmul's share of its bound, its ratio to torch.matmul and its
     time before the wgmma redesign; the RMSNorm-matmul's share of its
     bound, its ratio to the unfused pair and its time before its wgmma
     redesign;
  8. train the flagship at full width (vocab 32768, d_model 2048, 16
     heads, 8 layers, d_ff 8192, max_seq 1024, learned positions; ~539 M
     fp32 parameters from a seed) on a synthetic token file: first one
     step's loss and gradients with the flash kernels against the same
     step with plain dense attention, then fit() for 10 steps at batch 16
     with finite, falling losses and n_layers x steps launches of each
     flash kernel; then (informational) the same fit with dense attention
     and one step under torch.profiler;
  9. the fused training path (norm_impl="fused", and the fused flash
     backward selected through flash.TUNE_FILE): one step against the
     split/plain-pair step of phase 8, then 10 make_train_step steps on
     [16, 1025] windows with finite, falling losses, exactly 2 x n_layers
     norm-matmul and n_layers fused-backward launches a step and no split
     launch; two steps from the seed run again must give bit-equal losses;
     its step time beside phase 8's, and one profiled step;
 10. a short GQA training run (8 heads over 2 kv heads, d_head 128, rope,
     2 layers), so the grouped forward and backward run inside training;
 11. the ring kernels (csrc/ring.cu) against their plain versions on a
     virtual ring of 4 ranks at the flagship's tp-4 shapes (all-gather-
     matmul at x [4096, 2048] per rank against the wqkv, w1 and wo^T
     shards, matmul-reduce-scatter at [16384, 512] @ wo, [16384, 2048] @
     w2 and [16384, 1536] @ wqkv^T: every shape of the DP×TP step's
     forward and backward; the shift at k/v blocks [16, 16, 256, 128]),
     then n 1 and 2, odd m,
     a ragged K and two groups: y elementwise and per row
     (collective_matmul.ELEM_TOL, ROW_TOL), the gathered operand and the
     shift byte-equal, the VJPs against autograd through the plain
     versions;
 12. their times beside bound, plain version and library yardstick; each
     ring matmul's share of its bound, its ratio to the library call and
     its time before the wgmma redesign;
 13. DP×TP on Mesh({"dp": 1, "tp": 4}): the flagship's
     make_sharded_train_step(attn_impl="flash",
     matmul_impl="fused_collective") step against the dense sharded step,
     then 10 SGD steps with exact ring launch counts, its step time beside
     the dense step's, and one profiled step (the ring kernels' device
     time and the step's idle share);
 14. DP×SP on Mesh({"dp": 1, "sp": 4}): make_ring_train_step(ring_impl=
     "flash", hop_impl="pallas") bit-equal to hop_impl="xla", held to the
     one-device flash step, then 10 steps with an exact shift count;
 15. the quantized weight forms (quant.py) at the serving model's matmul
     shapes (K x N of wqkv, wo, w1, w2 and unembed; 8, 32 and 256 rows):
     the int8 product through torch._int_mm bit-equal to its plain int32
     version (with the weight column-major, as quantize_int8 stores it,
     and row-major), and the whole int8_matmul bit-equal to the plain
     version on the CPU; int4 (bf16 operands, fp32 accumulation) within
     INT4_CARD_REL of the fp32 plain version; the STE backward and LoRA
     over an int8 base within one bf16 rounding; their times beside
     torch.matmul of the bf16 weights (informational);
 16. serve the headline configuration (phase 4's model and requests) with
     int8 weights from the seed through serve(), on the slab (32 slots,
     chunk 8) and on pages (64-token pages, 160 pages): every answer held
     to the port's greedy_decode on the card under argmax_tol, an int8
     product on every matmul (counts), the paged run launching the paged
     attention kernel n_layers times a decode step and the slab run never;
     one decode step of each layout at 32 slots under torch.profiler, and
     tpu_dra_torch.bench.section_decode (bf16, int8 and int4 decode
     tokens/s; both informational);
 17. speculative serving at full width: phase 16's model, int8, with a
     draft made by spec_draft.make_draft (2 layers distilled 150 steps at
     batch 16, seq 256 from the fp32 tree, then int8), served through
     serve(draft=..., speculative_engine=True) at 16 slots, chunk 8, on
     the slab and on pages (64-token pages, 320 pages), 32 requests with
     prompts of 16-128 tokens and 32-128 steps: every answer held to the
     plain engine's of its layout under argmax_tol, the paged-attention
     kernel launched exactly draft layers x chunk times a pass on pages
     and never on the slab, a sampled batch of 8 in range; draft ==
     target accepting every proposal on the slab (on pages
     informational); plain and speculative tokens/s, accept rate, tokens
     per pass, the distillation's seconds and one pass of each layout
     under torch.profiler (informational).
The second-to-last line is a JSON object describing every kernel (eleven
entries: the flash forward once for each TPU kernel it replaces);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

HERE = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): the bound of a kernel is the
# larger of its bytes over the memory rate and its flops over the bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# full-width headline serving model (bench.py section_paged) and engine
MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_kv_heads=2,
             n_layers=8, d_ff=4096, max_seq=1024, pos_emb="rope")
ENGINE = dict(slots=32, chunk=8, page_size=64, total_pages=160,
              kv_layout="paged")
# full-width flagship training model (bench.py section_train) and its run
TRAIN_MODEL = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=8,
                   d_ff=8192, max_seq=1024, pos_emb="learned")
TRAIN_RUN = dict(steps=10, batch=16)
# the serving model's attention shape inside a short training run
GQA_MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_kv_heads=2,
                 n_layers=2, d_ff=4096, max_seq=1024, pos_emb="rope")
GQA_RUN = dict(steps=3, batch=8)
TOKENS = 2_200_000              # synthetic training tokens (uint16)
SEED = 0
# one full-width train step, flash kernels vs plain dense attention (the
# dense path rounds its scores to bf16 before the softmax, flash keeps
# them in fp32): the first run on an H100 80GB HBM3 at 700 W gave a loss
# gap of 2.9e-5 (flagship)
# and 3.7e-4 (GQA) and worst leaves of 0.0072 and 0.0065 relative L2
STEP_LOSS_ATOL = 5e-3
STEP_LEAF_REL = 3e-2
# the tune table that selects the fused flash backward at the flagship's
# attention shape (the counterpart of bench_cache/flash_tune.json)
FUSED_TUNE = {"entries": {"1024x128": {"bwd_impl": "fused"}}}
# (m, k, n) of the tiled matmul: the bench's 4096^3, k = 512, a rectangle
# and ragged tiles; of the fused RMSNorm-matmul: the flagship's ln1 -> wqkv
# and ln2 -> w1 at B·S = 16384, m < 256, K = 64 and K = 1024
MATMUL_CASES = [(4096, 4096, 4096), (1024, 512, 2048), (2048, 1024, 3072),
                (200, 512, 264)]
RMSNORM_CASES = [(16384, 2048, 6144), (16384, 2048, 8192), (100, 2048, 2048),
                 (512, 64, 256), (1024, 1024, 1024)]
# phases 13-14: plain SGD at the reference's learning rate
# (make_sharded_train_step's default) on [16, 1025] windows of the phase-8
# corpus, over a virtual mesh of 4 ranks on the one card
SGD_LR = 1e-2
SHARDED_RUN = dict(steps=10, batch=16)
# a ring VJP against autograd through the plain versions: the Functions
# round each fp32 sum to bf16 once, autograd through the plain version
# rounds each rank's share before it sums the ranks (0.0026 relative L2
# for the gather's dx at phase 11's VJP shapes in a CPU run of the plain
# paths)
VJP_REL = 1e-2
# the flash forward's card time before its TMA/wgmma redesign (the first
# version: mma.sync, 64-row blocks, one synchronous K/V stage), phase 6 on
# an H100 80GB HBM3 at 700 W (PERF.md §6)
FWD_BEFORE_US = {"flagship [256, 1024, 128]": "598.1-603.2",
                 "GQA run [64 over 16, 1024, 128]": "177.8-179.9"}
# the fused flash backward's and the plain matmul's card times before their
# TMA/wgmma redesign (the fused backward: per-tile dq slots on the mma.sync
# dK/dV kernel; the matmul: the first version, an mma.sync m16n8k16
# mainloop fed by ldmatrix, since deleted), phases 6 and 7 on an H100 80GB
# HBM3 at 700 W (PERF.md §6)
FUSED_BEFORE_US = {"flagship [256, 1024, 128]": "1897.4",
                   "GQA run [64 over 16, 1024, 128]": "539.7"}
MATMUL_BEFORE_US = "481.2-492.7"
# the split flash backward's card times before its TMA/wgmma redesign (the
# first version: mma.sync, 64-row dq blocks, 64-key dK/dV blocks over
# 32-row q tiles, synchronous tile loads), phase 6 on an H100 80GB HBM3 at
# 700 W (PERF.md §6)
SPLIT_BEFORE_US = {
    "flagship [256, 1024, 128]": "dq 669.0-677.6 us, dK/dV 1065.9-1080.6 us",
    "GQA run [64 over 16, 1024, 128]": "dq 202.0-207.6 us, dK/dV "
                                       "311.4-321.0 us"}
# the ring matmuls' card time before their wgmma redesign (the first
# version: the mma.sync m16n8k16 mainloop, since deleted), phase 12 on an
# H100 80GB HBM3 at 700 W (PERF.md §6)
RING_BEFORE_US = {"all_gather_matmul wqkv": "1707.9-1717.1",
                  "all_gather_matmul w1": "2243.7-2414.7",
                  "matmul_reduce_scatter w2": "2435.4-2546.7",
                  "matmul_reduce_scatter wo": "975.8-1015.6"}
# the RMSNorm-matmul's card time before its wgmma redesign (the first
# version: the same mma.sync mainloop, 128 x 128 tiles, x normalised on its
# way through registers into shared memory), phase 7 on an H100 80GB HBM3
# at 700 W (PERF.md §6)
NORM_BEFORE_US = {"rmsnorm_matmul ln1 -> wqkv": "2189.2-2321.7",
                  "rmsnorm_matmul ln2 -> w1": "2883.9-3101.1"}
# the paged attention's card time before its split-page redesign (the
# first version: one block per (slot, kv head), 8 warps over 8-token tiles,
# no copies in flight) on an H100 80GB HBM3 at 700 W (PERF.md §6): at the
# serving step phase 3's loop of launches; at 4 slots of 1024 tokens
# `python -m tpu_dra_torch.kernels.variants paged --before` with the first
# version's source (a loop of launches, then a CUDA graph)
PAGED_BEFORE_US = {"serving decode step [32 slots, lengths 257-320]":
                   "20.5-21.9 (a loop of launches), 19.0-19.1 (a CUDA graph)",
                   "4 slots at 1024 tokens":
                   "48.7-49.4 (a loop of launches), 47.5-48.1 (a CUDA graph)"}
# (prompt length, steps) of the served requests
REQUESTS = [(16, 32), (24, 128), (37, 45), (50, 96), (64, 60), (77, 110),
            (100, 77), (128, 128)]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    from CUDA events around the whole run."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn, iters: int = 200, reps: int = 5) -> float:
    """Mean device time of ``fn()`` from a CUDA graph of ``iters`` calls
    replayed ``reps`` times: the host's launch cost, which a loop of
    launches measures for a kernel of a few microseconds, drops out.
    ``fn`` must launch its work on the current stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def attention_case(gen, lengths, *, H=8, Hkv=2, Dh=128, P=160, ps=64,
                   MP=16, quantized=False):
    """Decode-step attention inputs on the card: scrambled page ids, -1
    past each slot's pages."""
    import torch

    from tpu_dra_torch.workloads.quant import quantize_kv
    dev = gen.device
    B = len(lengths)
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((Hkv, P, ps, Dh), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((Hkv, P, ps, Dh), generator=gen, device=dev).to(
        torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    pages = torch.randint(0, P, (B, MP), generator=gen, device=dev,
                          dtype=torch.int32)
    used = (lengths + ps - 1) // ps
    live = torch.arange(MP, device=dev)[None] < used[:, None]
    table = torch.where(live, pages, torch.full_like(pages, -1))
    extra = {}
    if quantized:
        k, k_s = quantize_kv(k)
        v, v_s = quantize_kv(v)
        extra = {"k_s": k_s, "v_s": v_s}
    return (q, k, v, table.contiguous(), lengths), extra


def check_kernel(gen, full_gen) -> float:
    """The kernel against its plain version on the same inputs, at the
    serving path's 32 slots (inputs from ``gen``) and at 4 slots of the
    full context (from ``full_gen``), bf16 and int8 pages: elementwise
    within the reference's rtol/atol, each slot within SLOT_REL_TOL
    relative L2 error on its own scale (the outputs of a long slot are too
    small for the elementwise bound to bind), and a second call bit-equal
    to the first."""
    import torch

    from tpu_dra_torch.workloads.paged_kv import (SLOT_REL_TOL,
                                                  paged_attention,
                                                  paged_attention_ref,
                                                  slot_rel_err)
    ps, MP = 64, 16
    specials = [0, 1, ps, ps + 1, 100, MP * ps, 2 * ps - 1, 7 * ps + 33]
    rand = torch.randint(1, MP * ps + 1, (32 - len(specials),),
                         generator=gen, device=gen.device).tolist()
    cases = {"32 slots": (gen, specials + rand),
             "4 slots at the full context": (full_gen, [MP * ps] * 4)}
    worst = 0.0
    for label, (g, lengths) in cases.items():
        for quantized, tol in ((False, 0.05), (True, 0.08)):
            args, extra = attention_case(g, lengths, quantized=quantized)
            got = paged_attention(*args, **extra)
            again = paged_attention(*args, **extra)
            torch.cuda.synchronize()
            want = paged_attention_ref(*args, **extra)
            gf, wf = got.float(), want.float()
            err = float((gf - wf).abs().max())
            ok = bool(torch.all((gf - wf).abs() <= tol + tol * wf.abs()))
            rel = slot_rel_err(got, want)
            b = int(rel.argmax())
            rel_ok = float(rel.max()) <= SLOT_REL_TOL
            same = torch.equal(got, again)
            if not torch.isfinite(gf).all():
                fail("paged attention kernel produced non-finite values")
            if 0 in lengths and not bool((gf[lengths.index(0)] == 0).all()):
                fail("zero-length slot did not give zeros")
            kind = "int8" if quantized else "bf16"
            log(f"[kernel] paged_attention {label}, {kind} pages: max "
                f"|kernel - plain| = {err:.5f} (rtol/atol {tol}) -> "
                f"{'ok' if ok else 'FAIL'}; worst slot relative L2 error "
                f"{float(rel.max()):.5f} (slot {b}, length {lengths[b]}; "
                f"median {float(rel.median()):.5f}; tolerance "
                f"{SLOT_REL_TOL}) -> {'ok' if rel_ok else 'FAIL'}; a second "
                f"call bit-equal: {same}")
            if not (ok and rel_ok):
                fail(f"paged attention kernel disagrees with its plain "
                     f"version ({label}, {kind} pages, max abs err {err}, "
                     f"worst slot relative error {float(rel.max())})")
            if not same:
                fail(f"paged attention kernel: two calls differ ({label}, "
                     f"{kind} pages)")
            worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 3: timing at one decode step of a full pool
# ---------------------------------------------------------------------------

# phase 3's shapes: (label, slots, shortest and longest length)
PAGED_SHAPES = [("serving decode step [32 slots, lengths 257-320]", 32, 257,
                 320),
                ("4 slots at 1024 tokens", 4, 1024, 1024)]


def time_kernel(gen, n_layers: int, B: int, lo: int, hi: int) -> dict:
    """Kernel, plain version and library yardstick at one decode step of
    the served model: B slots with lengths in [lo, hi], each its pages
    from a permutation of the 160-page pool (5 pages each at the serving
    step's 32 slots; 16 at 4 slots of 1024 tokens).  The kernel cycles
    through ``n_layers`` distinct layer pools, as one decode step does, so
    its pages come from device memory rather than the 50 MB L2 cache."""
    import torch
    import torch.nn.functional as F

    from tpu_dra_torch.kernels.build import library
    from tpu_dra_torch.workloads.paged_kv import (_LOG2E, paged_attention,
                                                  paged_attention_ref,
                                                  workspace_floats)
    dev = gen.device
    H, Hkv, Dh, P, ps, MP = 8, 2, 128, 160, 64, 16
    npg = -(-hi // ps)                          # pages a slot
    lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    table = torch.full((B, MP), -1, dtype=torch.int32, device=dev)
    table[:, :npg] = perm[:B * npg].reshape(B, npg)
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    k_all = torch.randn((n_layers, Hkv, P, ps, Dh), generator=gen,
                        device=dev).to(torch.bfloat16)
    v_all = torch.randn((n_layers, Hkv, P, ps, Dh), generator=gen,
                        device=dev).to(torch.bfloat16)

    # the kernel alone: its C entry point with the arguments prepared once
    lib = library("paged_attention")
    qs = (q * float(torch.tensor(Dh ** -0.5 * _LOG2E,
                                 dtype=torch.bfloat16))).contiguous()
    out = torch.empty_like(q)
    ws = torch.empty(workspace_floats(B, H, Hkv, Dh, MP, ps), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    layer = [0]

    def kernel(stream=stream):
        i = layer[0] = (layer[0] + 1) % n_layers
        rc = lib.tpu_dra_paged_attention(
            qs.data_ptr(), k_all[i].data_ptr(), v_all[i].data_ptr(), None,
            None, table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ws.data_ptr(), B, H, Hkv, P, ps, Dh, MP, 0, stream)
        if rc:
            fail(f"kernel launch failed with CUDA error {rc}")

    def wrapper():
        i = layer[0] = (layer[0] + 1) % n_layers
        paged_attention(q, k_all[i], v_all[i], table, lengths)

    def plain():
        i = layer[0] = (layer[0] + 1) % n_layers
        paged_attention_ref(q, k_all[i], v_all[i], table, lengths)

    # library yardstick: one PyTorch attention call over K/V already
    # gathered into contiguous [B, Hkv, S, Dh] — it leaves the page gather
    # out, so it is cheaper work than the kernel's; the port never calls it
    S = npg * ps
    tab = table[:, :npg].long()
    kg = [k_all[i][:, tab].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, Dh)
          .contiguous() for i in range(n_layers)]
    vg = [v_all[i][:, tab].permute(1, 0, 2, 3, 4).reshape(B, Hkv, S, Dh)
          .contiguous() for i in range(n_layers)]
    mask = (torch.arange(S, device=dev)[None] < lengths[:, None])[:, None,
                                                                   None]
    q4 = q[:, :, None]

    def library_call():
        i = layer[0] = (layer[0] + 1) % n_layers
        F.scaled_dot_product_attention(q4, kg[i], vg[i], attn_mask=mask,
                                       enable_gqa=True)

    # every call as a loop of launches, the way the served step launches
    # them (at a few microseconds a call the host's launch rate may bound
    # it); the kernel and the library call also from CUDA graphs, where
    # the host's launch cost drops out (graph_ms, library_graph_ms)
    t = {"ms": cuda_time_ms(kernel, 400),
         "wrapper_ms": cuda_time_ms(wrapper, 200),
         "plain_ms": cuda_time_ms(plain, 40),
         "library_ms": cuda_time_ms(library_call, 200),
         "graph_ms": cuda_graph_ms(
             lambda: kernel(torch.cuda.current_stream().cuda_stream)),
         "library_graph_ms": cuda_graph_ms(library_call)}
    live = int(lengths.sum())
    pages_read = int(((lengths + ps - 1) // ps).sum())
    nbytes = (2 * live * Hkv * Dh * 2          # live K and V rows, bf16
              + 2 * B * H * Dh * 2             # q in, out
              + pages_read * 4 + B * 4)        # live table entries, lengths
    flops = 4 * H * Dh * live                  # q.k and p.v per token
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    t["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    t["bytes"], t["flops"] = nbytes, flops
    return t


# ---------------------------------------------------------------------------
# phase 4: serve the full-width model
# ---------------------------------------------------------------------------

def post(port: int, body: dict, timeout: float = 600) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def oracle(cfg, params, prompt, steps):
    """The port's own per-request greedy decoder on the card."""
    import torch

    from tpu_dra_torch.workloads.paged_kv import PagePool, paged_greedy_decode
    pool = PagePool(ENGINE["total_pages"], ENGINE["page_size"])
    row = pool.table_row(pool.alloc(pool.pages_for(len(prompt) + steps)),
                         cfg.max_seq // ENGINE["page_size"])
    dev = torch.device("cuda", 0)
    return paged_greedy_decode(
        cfg, params, torch.tensor([prompt], device=dev),
        torch.from_numpy(row[None]).to(dev), steps=steps,
        total_pages=ENGINE["total_pages"],
        page_size=ENGINE["page_size"])[0].tolist()


def oracle_logits_at(cfg, params, prompt, tokens, step):
    """The oracle's logits at ``step`` when fed its own ``tokens``."""
    import torch

    from tpu_dra_torch.workloads.paged_kv import (PagePool, _paged_step,
                                                  init_paged_cache,
                                                  prefill_pages)
    dev = torch.device("cuda", 0)
    ps, P = ENGINE["page_size"], ENGINE["total_pages"]
    pool = PagePool(P, ps)
    row = pool.table_row(pool.alloc(pool.pages_for(len(prompt) + step + 1)),
                         cfg.max_seq // ps)
    table = torch.from_numpy(row[None]).to(dev)
    cache = init_paged_cache(cfg, P, ps, device=dev)
    lens = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
    logits = prefill_pages(cfg, params, cache,
                           torch.tensor([prompt], device=dev), lens, table)
    for i in range(step):
        tok = torch.tensor([tokens[i]], dtype=torch.int32, device=dev)
        cache, logits, lens = _paged_step(cfg, params, cache, tok, lens,
                                          table)
    return logits[0].float()


def argmax_tol(top: float) -> float:
    """Where the served answer and the oracle may part: the oracle's
    top-2 margin within twice four bf16 ulps of the top logit (2 x
    max(2^-4, 2^-6 |top|)).  The engine runs 32 slots and bucket-padded
    prefills, the oracle one row, so cuBLAS takes other kernels and sums
    in another order; every bf16 rounding downstream may then land one
    ulp apart — the same rule the CPU parity tests apply."""
    return 2 * max(2 ** -4, 2 ** -6 * abs(top))


def serve_requests(label: str, cfg, params, engine: dict,
                   prompts: list, requests: list = REQUESTS,
                   sampled: int = 0) -> dict:
    """Start serve() on port 0 with ``engine``, POST one request first
    (first-use costs), then the ``requests`` at once, one client thread
    each; fail on any error or a wrong count.  Counts the paged-attention
    launches and the int8 products of the concurrent part, and returns
    the engine's stats after it.  ``sampled``: then one /generate of that
    many of the prompts at temperature 0.8, every answer of its length
    and every token in range."""
    from tpu_dra_torch.workloads.paged_kv import paged_attention
    from tpu_dra_torch.workloads.quant import int8_product
    from tpu_dra_torch.workloads.serve import serve
    srv = serve(cfg, params, port=0, **engine)
    try:
        port = srv.server_address[1]
        post(port, {"tokens": [[1, 2, 3]], "steps": 2})   # first-use costs
        srv.engine.reset_stats()
        results: dict[int, object] = {}
        lat: dict[int, float] = {}

        def client(i):
            t = time.perf_counter()
            try:
                results[i] = post(port, {"tokens": [prompts[i]],
                                         "steps": requests[i][1]})
            except Exception as exc:  # noqa: BLE001 — reported below
                results[i] = exc
            lat[i] = time.perf_counter() - t

        paged_attention.launches = 0
        int8_product.calls = 0
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        launches, int8_calls = paged_attention.launches, int8_product.calls
        stats = srv.engine.stats()
        if sampled:
            rows = post(port, {"tokens": prompts[:sampled], "steps": 32,
                               "temperature": 0.8, "seed": 7})["tokens"]
            if len(rows) != sampled or not all(
                    len(r) == 32 and all(0 <= t < cfg.vocab for t in r)
                    for r in rows):
                fail(f"{label}: the sampled batch gave {rows!r:.300}")
            log(f"[{label}] a sampled batch of {sampled} requests at "
                f"temperature 0.8: 32 tokens each, all in range")
    finally:
        srv.shutdown()
    answers = []
    for i, (n, steps) in enumerate(requests):
        res = results.get(i)
        if not isinstance(res, dict):
            fail(f"{label}: request {i} failed: {res!r}")
        toks = res["tokens"][0]
        if len(toks) != steps or not all(0 <= t < cfg.vocab for t in toks):
            fail(f"{label}: request {i}: {len(toks)} tokens for {steps} "
                 f"steps")
        answers.append(toks)
    n_tok = sum(len(a) for a in answers)
    log(f"[{label}] {len(requests)} concurrent requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s, p50 latency "
        f"{1e3 * statistics.median(lat.values()):.1f} ms (informational)")
    return {"answers": answers, "launches": launches,
            "int8_calls": int8_calls, "decode_steps": stats["decode_steps"],
            "stats": stats, "tokens_per_s": n_tok / wall,
            "p50_latency_ms": 1e3 * statistics.median(lat.values())}


def hold_answers(label: str, answers: list, want_fn, logits_at,
                 requests: list = REQUESTS) -> int:
    """Each served answer against the oracle ``want_fn(i)`` on the card:
    equal, or departing only where the oracle's top-2 margin at the first
    difference (``logits_at(i, want, step)``) is within argmax_tol.
    Returns the number of tokens compared equal."""
    import torch
    compared = 0
    with torch.no_grad():
        for i, ((n, steps), toks) in enumerate(zip(requests, answers)):
            want = want_fn(i)
            diff = next((j for j, (a, b) in enumerate(zip(toks, want))
                         if a != b), None)
            if diff is None:
                compared += steps
                log(f"[{label}] request {i} (prompt {n}, steps {steps}): "
                    f"equals the oracle")
                continue
            lg = logits_at(i, want, diff)
            top2 = torch.topk(lg, 2).values.tolist()
            margin, tol = top2[0] - top2[1], argmax_tol(top2[0])
            compared += diff
            log(f"[{label}] request {i} (prompt {n}, steps {steps}): equals "
                f"the oracle for {diff} tokens; at step {diff} the oracle's "
                f"top-2 margin is {margin:.4f} (tolerance {tol:.4f})")
            if margin > tol:
                fail(f"{label}: request {i} departs from the oracle at step "
                     f"{diff} where the oracle's margin {margin:.4f} > "
                     f"{tol:.4f}")
    n_tok = sum(len(a) for a in answers)
    log(f"[{label}] {compared} of {n_tok} served tokens compared equal to "
        f"the oracle before any near-tie")
    return compared


def request_prompts(vocab: int) -> list:
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n).tolist() for n, _ in REQUESTS]


def serve_phase(gen) -> dict:
    import torch

    from tpu_dra_torch.workloads.quant import cast_params_bf16
    from tpu_dra_torch.workloads.train import (ModelConfig, forward,
                                               init_params)
    cfg = ModelConfig(**MODEL)
    t0 = time.perf_counter()
    params = cast_params_bf16(init_params(cfg, gen))
    n_params = sum(t.numel() for t in params["blocks"].values()) + sum(
        t.numel() for k, t in params.items() if k != "blocks")
    log(f"[serve] full-width model: {n_params / 1e6:.1f} M bf16 params "
        f"from seed {SEED} in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        probe = forward(cfg, params, torch.arange(16, device="cuda")[None])
    if probe.shape != (1, 16, cfg.vocab) or not torch.isfinite(probe).all():
        fail(f"forward at full width gave {tuple(probe.shape)} / "
             f"non-finite logits")

    prompts = request_prompts(cfg.vocab)
    run = serve_requests("serve", cfg, params, ENGINE, prompts)
    launches, decode_steps = run["launches"], run["decode_steps"]
    log(f"[serve] kernel launches {launches} over {decode_steps} decode "
        f"steps: {launches / max(1, decode_steps):.2f} per decoded token "
        f"(n_layers = {cfg.n_layers})")
    if launches < cfg.n_layers * decode_steps or \
            decode_steps < max(s for _, s in REQUESTS) - 1:
        fail(f"paged attention kernel launched {launches} times for "
             f"{decode_steps} decode steps of {cfg.n_layers} layers")

    # each answer against the port's per-request decoder on the card
    hold_answers(
        "serve", run["answers"],
        lambda i: oracle(cfg, params, prompts[i], REQUESTS[i][1]),
        lambda i, want, step: oracle_logits_at(cfg, params, prompts[i],
                                               want, step))
    return run


# ---------------------------------------------------------------------------
# phase 5: flash kernels vs plain versions
# ---------------------------------------------------------------------------

def hold(label: str, name: str, got, want, row_tol: float,
         elem_tol: float | None = None) -> tuple:
    """Fail unless ``got`` is finite and within ``elem_tol`` (default
    ``flash.ELEM_TOL``) elementwise and ``row_tol`` per row (each leading
    index, ``flash.row_rel_err``) of ``want``; returns (max abs error,
    worst elementwise error as a share of its tolerance, worst row
    error)."""
    import torch

    from tpu_dra_torch.workloads.flash import ELEM_TOL, row_rel_err
    elem_tol = ELEM_TOL if elem_tol is None else elem_tol
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        fail(f"{label} {name}: shape {tuple(got.shape)} vs "
             f"{tuple(want.shape)} or non-finite values")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ratio = float((diff / (elem_tol + elem_tol * want.float().abs())).max())
    rows = row_rel_err(got, want)
    worst = float(rows.max())
    if ratio > 1 or worst > row_tol:
        fail(f"{label} {name}: max abs err {err:.3g} (elementwise "
             f"{ratio:.3g} of the tolerance), worst row relative error "
             f"{worst:.3g} (row {int(rows.argmax())}, tolerance "
             f"{row_tol})")
    return err, ratio, worst


def flash_inputs(gen, bh: int, bhkv: int, s: int, d: int):
    import torch
    dev = gen.device

    def draw(n):
        return torch.randn((n, s, d), generator=gen, device=dev).to(
            torch.bfloat16)
    return draw(bh), draw(bhkv), draw(bhkv), draw(bh)


def check_flash_case(gen, bh, bhkv, s, d, causal) -> tuple:
    """Each flash kernel against its plain version on one input; the
    backward kernels get the plain forward's out and l2, so each kernel
    is held alone.  Returns {kernel: (max abs err, elementwise ratio,
    worst head-row error)} and the max abs error of l2."""
    import torch

    from tpu_dra_torch.workloads import flash as F
    label = (f"flash [{bh} over {bhkv}, {s}, {d}] "
             f"{'causal' if causal else 'full'}")
    q, k, v, do = flash_inputs(gen, bh, bhkv, s, d)
    out, l2 = F.flash_attn_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_l2 = F.flash_attn_fwd_ref(q, k, v, causal)
    res = {"flash_fwd": hold(label, "out", out, ref_out, F.ROW_TOL["out"])}
    l2_err = float((l2 - ref_l2).abs().max())
    if not l2_err <= F.L2_ATOL:
        fail(f"flash {label} l2: max abs err {l2_err} > {F.L2_ATOL}")
    qs = F._prescale(q).contiguous()
    dd = (do.float() * ref_out.float()).sum(dim=-1, keepdim=True)
    dq = F.flash_bwd_dq(qs, k, v, do, ref_l2, dd, causal)
    dk, dv = F.flash_bwd_dkdv(qs, k, v, do, ref_l2, dd, causal)
    torch.cuda.synchronize()
    res["flash_bwd_dq"] = hold(label, "dq", dq,
                               F.flash_bwd_dq_ref(qs, k, v, do, ref_l2, dd,
                                                  causal), F.ROW_TOL["dq"])
    rk, rv = F.flash_bwd_dkdv_ref(qs, k, v, do, ref_l2, dd, causal)
    ek = hold(label, "dk", dk, rk, F.ROW_TOL["dk"])
    ev = hold(label, "dv", dv, rv, F.ROW_TOL["dv"])
    res["flash_bwd_dkdv"] = tuple(max(a, b) for a, b in zip(ek, ev))
    again = (F.flash_bwd_dq(qs, k, v, do, ref_l2, dd, causal),
             *F.flash_bwd_dkdv(qs, k, v, do, ref_l2, dd, causal))
    if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
        fail(f"{label}: two calls of the split backward differ")
    fused = F.flash_bwd_fused(qs, k, v, do, ref_l2, dd, causal)
    torch.cuda.synchronize()
    want = F.flash_bwd_fused_ref(qs, k, v, do, ref_l2, dd, causal)
    errs = [hold(label, f"fused {name}", g, w, F.ROW_TOL[name])
            for name, g, w in zip(("dq", "dk", "dv"), fused, want)]
    again = F.flash_bwd_fused(qs, k, v, do, ref_l2, dd, causal)
    if not all(torch.equal(a, b) for a, b in zip(fused, again)):
        fail(f"{label}: two calls of the fused backward differ")
    res["flash_bwd_fused"] = tuple(max(e) for e in zip(*errs))
    res["flash_bwd_fused (dq alone)"] = errs[0]
    return res, l2_err


def check_flash(gen) -> dict:
    """The path's shapes, then the edge cases; returns the max abs error
    of each kernel at the flagship path's shape."""
    path, l2_worst = check_flash_case(gen, 256, 256, 1024, 128, True)
    gqa, l2_err = check_flash_case(gen, 64, 16, 1024, 128, True)
    l2_worst = max(l2_worst, l2_err)
    for name in path:
        log(f"[flash] {name} at the path's shapes: max abs err "
            f"{path[name][0]:.4g} (elementwise {path[name][1]:.3f} of "
            f"the tolerance), worst head-row {path[name][2]:.3g}; GQA run "
            f"shape {gqa[name][0]:.4g} / {gqa[name][2]:.3g}")
    worst = {name: [0.0, 0.0, 0.0] for name in path}
    n = 0
    for s in (1, 63, 64, 65, 1000):
        for causal in (True, False):
            for g in (1, 4):
                for d in (64, 128):
                    res, l2_err = check_flash_case(gen, 8, 8 // g, s, d,
                                                   causal)
                    l2_worst = max(l2_worst, l2_err)
                    n += 1
                    for name, vals in res.items():
                        worst[name] = [max(a, b) for a, b in
                                       zip(worst[name], vals)]
    for name, (err, ratio, row) in worst.items():
        log(f"[flash] {name} over {n} edge cases: max abs err {err:.4g} "
            f"(elementwise {ratio:.3f} of the tolerance), worst head-row "
            f"{row:.3g} -> ok")
    from tpu_dra_torch.workloads.flash import ELEM_TOL, L2_ATOL, ROW_TOL
    log(f"[flash] l2 over all cases: max abs err {l2_worst:.3g}")
    log(f"[flash] tolerances: elementwise rtol = atol = {ELEM_TOL}; per "
        f"head-row {ROW_TOL}; l2 atol {L2_ATOL}")
    return {**{name: vals[0] for name, vals in path.items()},
            "flash_fwd_gqa": gqa["flash_fwd"][0]}


# ---------------------------------------------------------------------------
# phase 6: flash timing at the training path's shapes
# ---------------------------------------------------------------------------

def flash_bound(nbytes: int, flops: int) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def time_flash(gen, B: int, H: int, Hkv: int, S: int = 1024,
               D: int = 128, causal: bool = True) -> dict:
    """Kernel alone (its C entry, arguments prepared once), wrapper, plain
    version and library yardstick for each flash kernel at one training
    path's attention: the flagship's [B·H, S, D] = [256, 1024, 128] bf16
    causal (each operand 67 MB, more than the 50 MB L2 cache holds, so
    every call reads device memory), the GQA run's 64 q heads over 16 kv
    heads, or one rank's block of the DP×SP step, [256, 256, 128], causal
    on the diagonal and full on the other hops."""
    import torch
    import torch.nn.functional as TF

    from tpu_dra_torch.kernels.build import library
    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.train import weak_scalar
    BH, BHkv = B * H, B * Hkv
    q, k, v, do = flash_inputs(gen, BH, BHkv, S, D)
    out, l2 = F.flash_attn_fwd(q, k, v, causal)
    qs = F._prescale(q).contiguous()
    dd = (do.float() * out.float()).sum(dim=-1, keepdim=True)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))   # per q head
    # the fused kernel's scratch: dq's fp32 accumulator and its flags
    scratch = torch.empty(-(-F.fused_scratch_bytes(BH, S, S, D) // 4),
                          dtype=torch.float32, device=q.device)
    lf, lb = library("flash_fwd"), library("flash_bwd")
    stream = torch.cuda.current_stream().cuda_stream
    qscale = weak_scalar(D ** -0.5 * F._LOG2E, torch.bfloat16)
    P = lambda t: t.data_ptr()      # noqa: E731

    def checked(rc):
        if rc:
            fail(f"flash kernel launch failed with CUDA error {rc}")

    kernels = {
        "flash_fwd": lambda: checked(lf.tpu_dra_flash_fwd(
            P(q), P(k), P(v), P(out), P(l2), BH, BHkv, S, S, D, int(causal),
            qscale, stream)),
        "flash_bwd_dq": lambda: checked(lb.tpu_dra_flash_bwd_dq(
            P(qs), P(k), P(v), P(do), P(l2), P(dd), P(dq), BH, BHkv, S, S,
            D, int(causal), D ** -0.5, stream)),
        "flash_bwd_dkdv": lambda: checked(lb.tpu_dra_flash_bwd_dkdv(
            P(qs), P(k), P(v), P(do), P(l2), P(dd), P(dk), P(dv), BH, BHkv,
            S, S, D, int(causal), stream)),
        "flash_bwd_fused": lambda: checked(lb.tpu_dra_flash_bwd_fused(
            P(qs), P(k), P(v), P(do), P(l2), P(dd), P(dk), P(dv),
            P(scratch), P(dq), BH, BHkv, S, S, D, int(causal), F.KV_BLOCK,
            D ** -0.5, stream)),
    }
    args = (qs, k, v, do, l2, dd, causal)
    wrappers = {
        "flash_fwd": lambda: F.flash_attn_fwd(q, k, v, causal),
        "flash_bwd_dq": lambda: F.flash_bwd_dq(*args),
        "flash_bwd_dkdv": lambda: F.flash_bwd_dkdv(*args),
        "flash_bwd_fused": lambda: F.flash_bwd_fused(*args),
    }
    plains = {
        "flash_fwd": lambda: F.flash_attn_fwd_ref(q, k, v, causal),
        "flash_bwd_dq": lambda: F.flash_bwd_dq_ref(*args),
        "flash_bwd_dkdv": lambda: F.flash_bwd_dkdv_ref(*args),
        "flash_bwd_fused": lambda: F.flash_bwd_fused_ref(*args),
    }
    # library yardstick: one PyTorch call each way (never called by the
    # port); its backward computes dq, dk and dv together
    q4 = q.reshape(B, H, S, D).detach().requires_grad_()
    k4, v4 = (t.reshape(B, Hkv, S, D).detach().requires_grad_()
              for t in (k, v))
    do4 = do.reshape(B, H, S, D)
    gqa = Hkv != H
    o4 = TF.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                         enable_gqa=gqa)
    sdpa_fwd = cuda_time_ms(lambda: TF.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal, enable_gqa=gqa), 50)
    sdpa_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), do4, retain_graph=True), 20)
    library_ms = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                  "flash_bwd_dkdv": sdpa_bwd, "flash_bwd_fused": sdpa_bwd}

    # bounds from these inputs: each operand read once, each output written
    # once; the products count only the (row, key) pairs the mask keeps
    # (S(S+1)/2 under the causal mask), 2 flops per multiply-add
    tile = BH * S * D * 2                   # one bf16 [BH, S, D] operand
    kv = BHkv * S * D * 2                   # k or v
    stat = BH * S * 4                       # one fp32 [BH, S] row vector
    mac = BH * D * (S * (S + 1) // 2 if causal else S * S)   # one product
    sizes = {"flash_fwd": (2 * tile + 2 * kv + stat, 2 * 2 * mac),
             "flash_bwd_dq": (3 * tile + 2 * kv + 2 * stat, 3 * 2 * mac),
             # dk, dv are written per q head
             "flash_bwd_dkdv": (4 * tile + 2 * kv + 2 * stat, 4 * 2 * mac),
             # the dkdv kernel's work, dq written once more, one product more
             "flash_bwd_fused": (5 * tile + 2 * kv + 2 * stat,
                                 5 * 2 * mac)}
    t = {}
    for name in kernels:
        t[name] = {"ms": cuda_time_ms(kernels[name], 20),
                   "wrapper_ms": cuda_time_ms(wrappers[name], 20),
                   "plain_ms": cuda_time_ms(plains[name], 5, warmup=1),
                   "library_ms": library_ms[name], **flash_bound(*sizes[name])}
    t["flash_bwd_fused"]["scratch_bytes"] = F.fused_scratch_bytes(BH, S, S, D)
    return t


# ---------------------------------------------------------------------------
# phases 8-10: training through fit and the fused step
# ---------------------------------------------------------------------------

def write_tokens(path: Path, vocab: int) -> str:
    """A learnable synthetic stream from SEED: a random 64-token motif
    repeated, 5% of the tokens replaced by noise."""
    import numpy as np

    from tpu_dra_torch.workloads.data import TokenDataset
    rng = np.random.default_rng(SEED)
    toks = np.resize(rng.integers(0, vocab, 64), TOKENS)
    noise = rng.random(TOKENS) < 0.05
    toks[noise] = rng.integers(0, vocab, int(noise.sum()))
    TokenDataset.write(str(path), toks)
    return str(path)


def leaf_errors(got: dict, want: dict, prefix: str = "") -> dict:
    """Relative L2 error of each gradient leaf."""
    out = {}
    for name, w in want.items():
        if isinstance(w, dict):
            out.update(leaf_errors(got[name], w, prefix + name + "/"))
        else:
            g = got[name].float()
            out[prefix + name] = float((g - w.float()).norm()
                                       / w.float().norm())
    return out


def compare_step(gen, cfg, data_path: str, batch: int, label: str) -> int:
    """One train step's loss and gradients with the flash kernels against
    the same step with plain dense attention, same params and batch.
    Returns the model's parameter count."""
    import torch

    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.train import (grads_fn, init_params,
                                               tree_leaves)
    params = init_params(cfg, gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    toks = torch.from_numpy(next(batches(TokenDataset(data_path),
                                         batch=batch, seq=cfg.max_seq)))
    toks = toks.to(gen.device)
    loss_f, g_f = grads_fn(cfg, params, toks, attn_impl="flash")
    loss_d, g_d = grads_fn(cfg, params, toks, attn_impl="dense")
    hold_step(label, "flash kernels vs plain dense attention", loss_f, g_f,
              loss_d, g_d)
    del params, g_f, g_d
    torch.cuda.empty_cache()
    return n_params


def hold_step(label: str, what: str, loss_a, g_a, loss_b, g_b) -> None:
    """Fail unless two train steps' losses are within STEP_LOSS_ATOL and
    every gradient leaf within STEP_LEAF_REL relative L2."""
    errs = leaf_errors(g_a, g_b)
    worst = max(errs, key=errs.get)
    dl = abs(float(loss_a) - float(loss_b))
    log(f"[train] {label}: one step, {what}: loss {float(loss_a):.5f} vs "
        f"{float(loss_b):.5f} (|d| {dl:.2e}, tolerance {STEP_LOSS_ATOL}); "
        f"worst gradient leaf {worst} relative L2 {errs[worst]:.3e} "
        f"(tolerance {STEP_LEAF_REL}); median leaf "
        f"{statistics.median(errs.values()):.3e}")
    if not (dl <= STEP_LOSS_ATOL and errs[worst] <= STEP_LEAF_REL):
        fail(f"{label}: {what}: the steps depart (loss |d| {dl}, leaf "
             f"{worst} {errs[worst]})")


def fit_phase(cfg, data_path: str, steps: int, batch: int, label: str,
              n_params: int) -> dict:
    """fit() with attn_impl="flash"; the flash launch counts are zeroed
    just before and read just after.  Fails unless every logged loss is
    finite, the last is below the first, and each kernel launched
    n_layers x steps times."""
    import math

    import torch

    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.fit import fit
    stamps = []

    def record(line: str) -> None:
        stamps.append(time.perf_counter())
        log(f"[train]   {label} {line}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = {"flash_fwd": F.flash_attn_fwd, "flash_bwd_dq":
                F.flash_bwd_dq, "flash_bwd_dkdv": F.flash_bwd_dkdv}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = fit(cfg, data_path, steps=steps, batch=batch, attn_impl="flash",
              log_every=1, log_fn=record)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in res.losses) or \
            len(res.losses) != steps:
        fail(f"{label}: losses {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        fail(f"{label}: loss did not fall: {res.losses}")
    want = cfg.n_layers * steps
    if any(n != want for n in launches.values()):
        fail(f"{label}: flash launches {launches}, expected {want} each "
             f"(n_layers {cfg.n_layers} x steps {steps})")
    times = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    step_s = statistics.median(times[1:]) if len(times) > 1 else times[0]
    tok_step = batch * cfg.max_seq
    log(f"[train] {label}: {n_params / 1e6:.1f} M params, loss "
        f"{res.losses[0]:.4f} -> {res.losses[-1]:.4f} over {steps} steps; "
        f"step time {1e3 * step_s:.1f} ms (median of steps 2-{steps}; "
        f"first step {1e3 * times[0]:.1f} ms), tokens/s from the start "
        f"{res.tokens_per_s:.0f}, steady {tok_step / step_s:.0f}; "
        f"6·N·tokens/time/989e12 = "
        f"{6 * n_params * tok_step / step_s / BF16_FLOPS_PER_S:.3f}; "
        f"peak memory {peak_gb:.1f} GB; flash launches {launches} "
        f"(informational)")
    return {"launches": launches, "losses": res.losses, "step_ms":
            1e3 * step_s, "tokens_per_s": res.tokens_per_s, "peak_gb":
            peak_gb, "n_params": n_params}


def dense_curve(cfg, data_path: str, flash_losses: list) -> None:
    """The same fit (seed, batches, optimizer) with plain dense attention,
    its losses printed beside the flash run's (informational: the two
    differ by bf16 noise from the first step on, and AdamW carries that
    into the curves)."""
    import torch

    from tpu_dra_torch.workloads.fit import fit
    torch.cuda.empty_cache()
    res = fit(cfg, data_path, steps=len(flash_losses),
              batch=TRAIN_RUN["batch"], attn_impl="dense", log_every=1,
              log_fn=lambda line: None)
    pairs = ", ".join(f"{a:.4f}/{b:.4f}" for a, b in
                      zip(flash_losses, res.losses))
    log(f"[train] flagship losses, flash/dense attention by step: {pairs} "
        f"(informational)")


def busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` spans."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def kernel_kind(name: str) -> str:
    if "flash_" in name:
        return "flash kernels"
    if "ring_" in name:
        return "ring kernels (csrc/ring.cu)"
    if any(k in name for k in ("rownorm_kernel", "matmul_sm90_kernel",
                               "norm_sm90_kernel")):
        return "matmul kernels (csrc/matmul.cu)"
    if any(m in name.lower() for m in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmuls (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def profile_step(cfg, data_path: str, batch: int, label: str = "flagship",
                 norm_impl: str = "dense") -> None:
    """One train step (after two warm-up steps) under torch.profiler:
    device time by kernel kind and the device's idle share of the step
    (informational; the profiler's own overhead lengthens the traced
    step)."""
    import torch

    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.optim import default_optimizer
    from tpu_dra_torch.workloads.train import init_params, make_train_step
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen)
    step, init_opt = make_train_step(cfg, default_optimizer(),
                                     attn_impl="flash", norm_impl=norm_impl)
    state = init_opt(params)
    it = batches(TokenDataset(data_path), batch=batch, seq=cfg.max_seq)
    toks = [torch.from_numpy(next(it)).to("cuda") for _ in range(3)]
    for t in toks[:2]:
        params, state, _ = step(params, state, t)
    profile_call(f"{label} train step",
                 lambda: step(params, state, toks[2]))
    del params, state
    torch.cuda.empty_cache()


def profile_call(label: str, fn) -> dict:
    """``fn()`` once (warmed up by the caller) under torch.profiler: wall
    time, device busy time and idle share, device time by kernel kind and
    the top kernels (informational); returns the device time by kind in
    µs with ``wall`` and ``busy`` ({} where the profiler saw no device
    activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log("[profile] torch.profiler saw no device activity: device time "
            "by kernel not measured")
        return {}
    by_kind: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_kind[kernel_kind(e.name)] = by_kind.get(kernel_kind(e.name),
                                                   0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    log(f"[profile] {label} under torch.profiler: wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"(idle share {1 - busy / wall_us:.3f}), {len(kernels)} device "
        f"activities (informational)")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {kind}: {us / 1e3:.1f} ms "
            f"({us / busy:.3f} of device time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   top: {us / 1e3:.2f} ms {name[:110]}")
    return {**by_kind, "wall": wall_us, "busy": busy}


@contextlib.contextmanager
def fused_backward(tune_path: Path):
    """Point ``flash.TUNE_FILE`` at the table that selects the fused flash
    backward for the duration."""
    from tpu_dra_torch.workloads import flash as F
    default = F.TUNE_FILE
    F.TUNE_FILE = tune_path
    try:
        yield
    finally:
        F.TUNE_FILE = default


def fused_compare_step(gen, cfg, data_path: str, batch: int,
                       tune_path: Path) -> None:
    """One flagship step with norm_impl="fused" and the fused flash
    backward against the same step (params, [B, S + 1] batch) with the
    plain rmsnorm -> matmul pair and the split backward."""
    import torch

    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.train import grads_fn, init_params
    params = init_params(cfg, gen)
    toks = torch.from_numpy(next(batches(TokenDataset(data_path),
                                         batch=batch, seq=cfg.max_seq)))
    toks = toks.to(gen.device)
    with fused_backward(tune_path):
        loss_f, g_f = grads_fn(cfg, params, toks, attn_impl="flash",
                               norm_impl="fused")
    loss_s, g_s = grads_fn(cfg, params, toks, attn_impl="flash")
    hold_step("flagship", "fused norm-matmul and fused flash backward vs "
              "the plain pair and the split backward", loss_f, g_f, loss_s,
              g_s)
    del params, g_f, g_s
    torch.cuda.empty_cache()


def fused_train_phase(cfg, data_path: str, tune_path: Path, steps: int,
                      batch: int, n_params: int, split_step_ms: float
                      ) -> dict:
    """``make_train_step(norm_impl="fused")`` with the fused flash backward
    for ``steps`` steps on ``data.batches`` windows [batch, S + 1]; the
    kernels' launch counts are zeroed just before and read just after.
    Fails unless every loss is finite, the last is below the first, each
    layer ran the norm-matmul kernel twice and the fused backward once a
    step, neither split backward kernel ran, and the first two steps, run
    again from the seed, give bit-equal losses."""
    import math

    import torch

    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads import matmul as M
    from tpu_dra_torch.workloads.data import TokenDataset, batches
    from tpu_dra_torch.workloads.optim import default_optimizer
    from tpu_dra_torch.workloads.train import init_params, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen)
    step, init_opt = make_train_step(cfg, default_optimizer(),
                                     attn_impl="flash", norm_impl="fused")
    state = init_opt(params)
    it = batches(TokenDataset(data_path), batch=batch, seq=cfg.max_seq)
    counters = {"rmsnorm_matmul": M.fused_rmsnorm_matmul,
                "flash_bwd_fused": F.flash_bwd_fused,
                "flash_fwd": F.flash_attn_fwd, "flash_bwd_dq": F.flash_bwd_dq,
                "flash_bwd_dkdv": F.flash_bwd_dkdv}
    losses, stamps, first = [], [], []
    with fused_backward(tune_path):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            toks = torch.from_numpy(next(it)).to("cuda")
            if len(first) < 2:
                first.append(toks)
            params, state, loss = step(params, state, toks)
            losses.append(float(loss))
            stamps.append(time.perf_counter())
        launches = {name: fn.launches for name, fn in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the same two steps again from the seed: the second loss carries
        # the first step's fused backward, so it must repeat bit for bit
        del params, state
        gen.manual_seed(SEED)
        params = init_params(cfg, gen)
        state = init_opt(params)
        again = []
        for toks in first:
            params, state, loss = step(params, state, toks)
            again.append(float(loss))
    log(f"[train] fused path, two steps from the seed run again: losses "
        f"{', '.join(repr(x) for x in again)} against "
        f"{', '.join(repr(x) for x in losses[:2])}")
    if again != losses[:2]:
        fail(f"fused path: two steps from one seed gave losses {again}, "
             f"then {losses[:2]}")
    log(f"[train] fused path losses by step (full precision, to compare "
        f"calls bit for bit): {', '.join(repr(x) for x in losses)}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        fail(f"fused path: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"fused path: loss did not fall: {losses}")
    want = {"rmsnorm_matmul": 2 * cfg.n_layers * steps,
            "flash_bwd_fused": cfg.n_layers * steps,
            "flash_fwd": cfg.n_layers * steps, "flash_bwd_dq": 0,
            "flash_bwd_dkdv": 0}
    if launches != want:
        fail(f"fused path: launches {launches}, expected {want}")
    times = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    step_s = statistics.median(times[1:])
    tok_step = batch * cfg.max_seq
    log(f"[train] fused path (norm_impl=\"fused\", fused flash backward): "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps; "
        f"step time {1e3 * step_s:.1f} ms (median of steps 2-{steps}; first "
        f"step {1e3 * times[0]:.1f} ms) against {split_step_ms:.1f} ms for "
        f"the split path's fit step in this run; steady "
        f"{tok_step / step_s:.0f} tokens/s; 6·N·tokens/time/989e12 = "
        f"{6 * n_params * tok_step / step_s / BF16_FLOPS_PER_S:.3f}; peak "
        f"memory {peak_gb:.1f} GB; launches {launches} (informational "
        f"times)")
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "step_ms": 1e3 * step_s,
            "peak_gb": peak_gb}


def train_phase(gen, tmp: Path) -> tuple:
    from tpu_dra_torch.workloads.train import ModelConfig
    cfg = ModelConfig(**TRAIN_MODEL)
    data_path = write_tokens(tmp / "tokens.bin", cfg.vocab)
    log(f"[train] synthetic corpus: {TOKENS} uint16 tokens (64-token motif, "
        f"5% noise, seed {SEED})")
    n = compare_step(gen, cfg, data_path, TRAIN_RUN["batch"], "flagship")
    run = fit_phase(cfg, data_path, TRAIN_RUN["steps"], TRAIN_RUN["batch"],
                    "flagship", n)
    dense_curve(cfg, data_path, run["losses"])
    profile_step(cfg, data_path, TRAIN_RUN["batch"])
    tune_path = tmp / "flash_tune.json"
    tune_path.write_text(json.dumps(FUSED_TUNE))
    fused_compare_step(gen, cfg, data_path, TRAIN_RUN["batch"], tune_path)
    fused = fused_train_phase(cfg, data_path, tune_path, TRAIN_RUN["steps"],
                              TRAIN_RUN["batch"], n, run["step_ms"])
    with fused_backward(tune_path):
        profile_step(cfg, data_path, TRAIN_RUN["batch"], "fused-path",
                     norm_impl="fused")
    gcfg = ModelConfig(**GQA_MODEL)
    n = compare_step(gen, gcfg, data_path, GQA_RUN["batch"], "GQA")
    gqa_run = fit_phase(gcfg, data_path, GQA_RUN["steps"], GQA_RUN["batch"],
                        "GQA", n)
    return run, fused, gqa_run


# ---------------------------------------------------------------------------
# phase 7: matmul kernels vs plain versions, timing, the bench section
# ---------------------------------------------------------------------------

def matmul_inputs(gen, m: int, k: int, n: int, norm: bool):
    """bf16 x ~ N(0, 1) and w; for the norm kernel rows of mixed scale, w
    at the init scale k^-0.5 and a gain 1 + 0.1·N(0, 1)."""
    import torch
    dev = gen.device
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev)
    if not norm:
        return x.to(torch.bfloat16), w.to(torch.bfloat16)
    scale = torch.rand((m, 1), generator=gen, device=dev) * 4 + 0.05
    g = 1 + 0.1 * torch.randn((k,), generator=gen, device=dev)
    return ((x * scale).to(torch.bfloat16), g,
            (w * k ** -0.5).to(torch.bfloat16))


def check_matmul(gen) -> dict:
    """Each matmul kernel against its plain version at every case; returns
    the max abs error at the path's shape (4096^3; the wqkv shape)."""
    import torch

    from tpu_dra_torch.workloads import matmul as M
    path = {}
    for name, cases in (("matmul", MATMUL_CASES),
                        ("rmsnorm_matmul", RMSNORM_CASES)):
        worst = [0.0, 0.0, 0.0]
        for m, k, n in cases:
            args = matmul_inputs(gen, m, k, n, name == "rmsnorm_matmul")
            kernel, plain = ((M.matmul, M.matmul_ref) if name == "matmul"
                             else (M.fused_rmsnorm_matmul,
                                   M.fused_rmsnorm_matmul_ref))
            got = kernel(*args)
            torch.cuda.synchronize()
            res = hold(f"{name} [{m}, {k}] @ [{k}, {n}]", "out", got,
                       plain(*args), M.ROW_TOL, M.ELEM_TOL)
            log(f"[matmul] {name} [{m}, {k}] @ [{k}, {n}]: max abs err "
                f"{res[0]:.4g} (elementwise {res[1]:.3f} of the "
                f"tolerance), worst row {res[2]:.3g} -> ok")
            path.setdefault(name, res[0])
            worst = [max(a, b) for a, b in zip(worst, res)]
            del args, got
        log(f"[matmul] {name} over {len(cases)} cases: elementwise "
            f"{worst[1]:.3f} of the tolerance, worst row {worst[2]:.3g}")
    log(f"[matmul] tolerances: elementwise rtol = atol = {M.ELEM_TOL}; per "
        f"row {M.ROW_TOL}")
    return path


def time_matmul(gen) -> dict:
    """Kernel alone (its C entry, arguments prepared once), wrapper, plain
    version and library yardstick of each matmul kernel at its path's
    shapes: the bench's 4096^3 for matmul, the flagship's ln1 -> wqkv and
    ln2 -> w1 for rmsnorm_matmul.  Bounds count each operand read once,
    the output written once and 2 FLOP per multiply-add of the product
    (the norm's ~3 FLOP per x element are left out)."""
    import torch

    from tpu_dra_torch.kernels.build import library
    from tpu_dra_torch.workloads import matmul as M
    from tpu_dra_torch.workloads.train import _rmsnorm
    lib = library("matmul")
    stream = torch.cuda.current_stream().cuda_stream
    P = lambda t: t.data_ptr()      # noqa: E731

    def checked(rc):
        if rc:
            fail(f"matmul kernel launch failed with CUDA error {rc}")
    times = {}
    x, y = matmul_inputs(gen, 4096, 4096, 4096, False)
    out = torch.empty((4096, 4096), dtype=torch.bfloat16, device=x.device)
    times["matmul 4096^3"] = {
        "ms": cuda_time_ms(lambda: checked(lib.tpu_dra_matmul(
            P(x), P(y), P(out), 4096, 4096, 4096, stream)), 50),
        "wrapper_ms": cuda_time_ms(lambda: M.matmul(x, y), 50),
        "plain_ms": cuda_time_ms(lambda: M.matmul_ref(x, y), 5, warmup=1),
        "library_ms": cuda_time_ms(lambda: torch.matmul(x, y), 50),
        "library": "torch.matmul, bf16",
        **flash_bound(3 * 4096 * 4096 * 2, 2 * 4096 ** 3)}
    del x, y, out
    for label, (m, k, n) in (("rmsnorm_matmul ln1 -> wqkv",
                              RMSNORM_CASES[0]),
                             ("rmsnorm_matmul ln2 -> w1", RMSNORM_CASES[1])):
        x, g, w = matmul_inputs(gen, m, k, n, True)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
        r = torch.empty(m, dtype=torch.float32, device=x.device)
        xn = torch.empty_like(x)
        log(f"[time] {label}: the plain tiled matmul kernel alone at the "
            f"same shape takes "
            f"{cuda_time_ms(lambda: M.matmul(x, w), 30) * 1e3:.1f} us "
            f"(informational: the norm's share is the difference)")
        times[f"{label} [{m}, {k}] @ [{k}, {n}]"] = {
            "ms": cuda_time_ms(lambda: checked(lib.tpu_dra_rmsnorm_matmul(
                P(x), P(g), P(w), P(r), P(xn), P(out), m, n, k, M.EPS,
                stream)), 30),
            "wrapper_ms": cuda_time_ms(
                lambda: M.fused_rmsnorm_matmul(x, g, w), 30),
            "plain_ms": cuda_time_ms(
                lambda: M.fused_rmsnorm_matmul_ref(x, g, w), 3, warmup=1),
            # two calls: the train trunk's unfused pair
            "library_ms": cuda_time_ms(
                lambda: torch.matmul(_rmsnorm(x, g), w), 30),
            "library": "two calls: train._rmsnorm, then torch.matmul",
            **flash_bound(m * k * 2 + k * 4 + k * n * 2 + m * n * 2,
                          2 * m * k * n)}
        del x, g, w, out, xn
    return times


def log_times(times: dict, card: str) -> None:
    for label, t in times.items():
        log(f"[time] {label}: kernel {t['ms'] * 1e3:.1f} us (through the "
            f"Python wrapper {t['wrapper_ms'] * 1e3:.1f} us), plain version "
            f"{t['plain_ms'] * 1e3:.1f} us, library yardstick "
            f"{t['library_ms'] * 1e3:.1f} us ({t['library']}); bound "
            f"{t['bound_ms'] * 1e3:.1f} us by {t['bound_by']} "
            f"({t['bytes']} B at 3.35 TB/s, {t['flops']} FLOP at 989 TF/s), "
            f"{t['bound_ms'] / t['ms']:.3f} of it reached, on {card}")


def bench_phase() -> dict:
    """``tpu_dra_torch.bench.section_pallas_matmul()``, the matmul kernel's
    path: its launch count is zeroed just before and read just after."""
    from tpu_dra_torch.bench import section_pallas_matmul
    from tpu_dra_torch.workloads.matmul import matmul
    matmul.launches = 0
    res = section_pallas_matmul()
    launches = matmul.launches
    log(f"[bench] section_pallas_matmul: {json.dumps(res)}; matmul kernel "
        f"launches {launches}")
    if launches < 200 or not res["pallas_matmul_tflops"] > 0:
        fail(f"section_pallas_matmul: {res}, {launches} launches")
    return {"launches": launches, **res}


def check_spills(built, pattern: str = "") -> None:
    """Fail if ptxas reported spill bytes, or wgmma serialized for want of
    registers (C7512), for a kernel of ``built`` whose mangled name
    matches ``pattern`` (every kernel where it is empty), from a fresh
    build's log (a reused library has none to read)."""
    if not built.log:
        log(f"[build] {built.path.name} was reused: no ptxas lines to check")
        return
    faults, name = [], ""
    for ln in built.log.splitlines():
        found = re.search(r"Function properties for (\S+)", ln)
        if found:
            name = found.group(1)
        elif re.search(r"[1-9]\d* bytes spill (stores|loads)", ln):
            if re.search(pattern, name):
                faults.append(f"{name}: {ln.strip()}")
        elif "C7512" in ln and any(re.search(pattern, f) for f in
                                   re.findall(r"'(\w+)'", ln)):
            faults.append(ln.strip())
    if faults:
        fail(f"ptxas spills or serialized wgmma in {built.path.name}: "
             f"{faults}")
    log(f"[build] {built.path.name}: no spills"
        + (f" in the kernels matching {pattern!r}" if pattern else ""))


def log_fwd_summary(shape: str, t: dict, card: str) -> None:
    """The forward's share of its bound, its ratio to the SDPA forward and
    its time before the redesign."""
    log(f"[time] flash_fwd at the {shape}: {t['ms'] * 1e3:.1f} us, "
        f"{t['bound_ms'] / t['ms']:.3f} of its {t['bound_ms'] * 1e3:.1f} us "
        f"bound ({t['bound_by']}), {t['ms'] / t['library_ms']:.2f}x the SDPA "
        f"forward's {t['library_ms'] * 1e3:.1f} us; before the TMA/wgmma "
        f"redesign {FWD_BEFORE_US[shape]} us; on {card}")


def log_fused_summary(shape: str, times: dict, card: str) -> None:
    """The fused backward's time, the SDPA backward's, its share of the
    bound, its scratch and the split pair's time in the same run."""
    t = times["flash_bwd_fused"]
    split = times["flash_bwd_dq"]["ms"] + times["flash_bwd_dkdv"]["ms"]
    log(f"[time] flash_bwd_fused at the {shape}: {t['ms'] * 1e3:.1f} us, "
        f"{t['bound_ms'] / t['ms']:.3f} of its {t['bound_ms'] * 1e3:.1f} us "
        f"bound ({t['bound_by']}), {t['ms'] / t['library_ms']:.2f}x the SDPA "
        f"backward's {t['library_ms'] * 1e3:.1f} us; scratch "
        f"{t['scratch_bytes']} B ({t['scratch_bytes'] / 1e9:.3f} GB); the "
        f"split pair (flash_bwd_dq + flash_bwd_dkdv) {split * 1e3:.1f} us; "
        f"before the TMA/wgmma redesign {FUSED_BEFORE_US[shape]} us; on "
        f"{card}")


def log_split_summary(shape: str, times: dict, card: str) -> None:
    """The split pair's times and shares of their bounds, the pair against
    the SDPA backward (which computes dq, dk and dv together) in the same
    run, and the pair's times before its TMA/wgmma redesign."""
    dq, kv = times["flash_bwd_dq"], times["flash_bwd_dkdv"]
    pair = dq["ms"] + kv["ms"]
    parts = [f"{name} {t['ms'] * 1e3:.1f} us ({t['bound_ms'] / t['ms']:.3f} "
             f"of its {t['bound_ms'] * 1e3:.1f} us bound by {t['bound_by']})"
             for name, t in (("flash_bwd_dq", dq), ("flash_bwd_dkdv", kv))]
    log(f"[time] split backward at the {shape}: {', '.join(parts)}; the "
        f"pair {pair * 1e3:.1f} us, {pair / dq['library_ms']:.2f}x the SDPA "
        f"backward's {dq['library_ms'] * 1e3:.1f} us; before the TMA/wgmma "
        f"redesign {SPLIT_BEFORE_US.get(shape, 'not measured')}; on {card}")


def log_matmul_summary(t: dict, benched: dict, card: str) -> None:
    """The plain matmul's share of its bound and its ratio to
    torch.matmul at 4096^3, and the bench section's rate."""
    log(f"[time] matmul 4096^3: {t['ms'] * 1e3:.1f} us, "
        f"{t['bound_ms'] / t['ms']:.3f} of its {t['bound_ms'] * 1e3:.1f} us "
        f"bound ({t['bound_by']}), {t['ms'] / t['library_ms']:.2f}x "
        f"torch.matmul's {t['library_ms'] * 1e3:.1f} us; "
        f"pallas_matmul_tflops {benched['pallas_matmul_tflops']}; before "
        f"the wgmma redesign {MATMUL_BEFORE_US} us; on {card}")


def log_norm_summary(times: dict, card: str) -> None:
    """The RMSNorm-matmul's share of its bound, its ratio to the unfused
    pair and its time before the wgmma redesign, at both path shapes."""
    for name, before in NORM_BEFORE_US.items():
        t = next(v for k, v in times.items() if k.startswith(name))
        log(f"[time] {name}: {t['ms'] * 1e3:.1f} us, "
            f"{t['bound_ms'] / t['ms']:.3f} of its {t['bound_ms'] * 1e3:.1f} "
            f"us bound ({t['bound_by']}), {t['ms'] / t['library_ms']:.2f}x "
            f"the unfused pair's {t['library_ms'] * 1e3:.1f} us; before the "
            f"wgmma redesign {before} us; on {card}")


def log_ring_summary(times: dict, card: str) -> None:
    """Each ring matmul's share of its bound, its ratio to the library
    call and its time before the wgmma redesign."""
    for name, before in RING_BEFORE_US.items():
        t = times[name]
        log(f"[time] {name}: {t['ms'] * 1e3:.1f} us, "
            f"{t['bound_ms'] / t['ms']:.3f} of its {t['bound_ms'] * 1e3:.1f} "
            f"us bound ({t['bound_by']}), {t['ms'] / t['library_ms']:.2f}x "
            f"the library call's {t['library_ms'] * 1e3:.1f} us; before the "
            f"wgmma redesign {before} us; on {card}")


def log_flash_times(shape: str, times: dict, card: str) -> None:
    for name, t in times.items():
        lib = ("forward" if name == "flash_fwd"
               else "backward: dq, dk, dv together")
        log(f"[time] {name} at the {shape}: kernel {t['ms'] * 1e3:.1f} us "
            f"(through the Python wrapper {t['wrapper_ms'] * 1e3:.1f} us), "
            f"plain version {t['plain_ms'] * 1e3:.1f} us, library "
            f"yardstick {t['library_ms'] * 1e3:.1f} us "
            f"(scaled_dot_product_attention {lib}); bound "
            f"{t['bound_ms'] * 1e3:.1f} us by {t['bound_by']} "
            f"({t['bytes']} B at 3.35 TB/s, {t['flops']} FLOP at 989 "
            f"TF/s), {t['bound_ms'] / t['ms']:.3f} of it reached, on {card}")


# ---------------------------------------------------------------------------
# phases 11-12: the ring kernels against their plain versions, and timed
# ---------------------------------------------------------------------------

def ring_inputs(gen, G: int, n: int, rows: int, k: int, n_out: int):
    """bf16 x ~ N(0, 1) [G, n, rows, K] and per-rank w at the init scale
    K^-0.5 [n, K, N], shared by the G groups (an expanded view)."""
    import torch
    dev = gen.device
    x = torch.randn((G, n, rows, k), generator=gen, device=dev).to(
        torch.bfloat16)
    w = (torch.randn((1, n, k, n_out), generator=gen, device=dev)
         * k ** -0.5).to(torch.bfloat16)
    return x, w.expand(G, -1, -1, -1)


def hold_ring(label: str, got, want) -> tuple:
    """A ring matmul's y against its plain version, elementwise and per
    output row (collective_matmul.ELEM_TOL, ROW_TOL)."""
    from tpu_dra_torch.workloads import collective_matmul as cm
    return hold(label, "y", got.flatten(0, -2), want.flatten(0, -2),
                cm.ROW_TOL, cm.ELEM_TOL)


def check_ring(gen) -> dict:
    """Phase 11: each ring kernel against its plain version at every shape
    the training paths launch it at (tp 4: the gather at x [4096, 2048]
    per rank against the wqkv and w1 shards, and against wo^T for wo's
    dx; the reduce-scatter at [16384, 512] @ wo and [16384, 2048] @ w2,
    and [16384, 1536] @ wqkv^T for wqkv's dx; w1's and w2's dx run the
    w2 and w1 shapes; the shift at k/v blocks [16, 16, 256, 128]),
    then n 1 and 2, odd m (the unidirectional gather), a ragged K and two
    groups; the gathered operand and the shift byte-equal; then the VJPs
    against autograd through the plain versions.  Returns the max abs
    error of each kernel at its path's first shape."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    cases = [  # (label, G, n, m, K, N)
        ("path: wqkv", 1, 4, 4096, 2048, 1536),
        ("path: w1", 1, 4, 4096, 2048, 2048),
        ("bwd: wo^T", 1, 4, 4096, 2048, 512),
        ("n 1", 1, 1, 512, 256, 256), ("n 2", 1, 2, 1024, 512, 384),
        ("odd m (unidirectional)", 1, 4, 1001, 256, 512),
        ("ragged K", 1, 4, 512, 200, 136), ("dp 2", 2, 4, 256, 512, 256)]
    errs = {}
    for label, G, n, m, k, n_out in cases:
        x, w = ring_inputs(gen, G, n, m, k, n_out)
        y, a = cm.all_gather_matmul(x, w)
        torch.cuda.synchronize()
        want_y, want_a = cm.all_gather_matmul_ref(x, w)
        if not torch.equal(a, want_a):
            fail(f"all_gather_matmul {label}: gathered operand not "
                 f"byte-equal")
        err, ratio, row = hold_ring(f"all_gather_matmul {label}", y, want_y)
        errs.setdefault("all_gather_matmul", err)
        log(f"[ring] all_gather_matmul {label} [G {G}, n {n}, m {m}, K {k}, "
            f"N {n_out}]: max abs err {err:.4g} (elementwise {ratio:.3f} of "
            f"the tolerance), worst row {row:.3g}; gathered operand "
            f"byte-equal -> ok")
        del x, w, y, a, want_y, want_a
    cases = [("path: w2", 1, 4, 4096, 2048, 2048),
             ("path: wo", 1, 4, 4096, 512, 2048),
             ("bwd: wqkv^T", 1, 4, 4096, 1536, 2048),
             ("n 1", 1, 1, 512, 256, 256), ("n 2", 1, 2, 1024, 512, 384),
             ("odd m", 1, 4, 1001, 256, 512), ("ragged K", 1, 4, 512, 200, 136),
             ("dp 2", 2, 4, 256, 512, 256)]
    for label, G, n, m, k, n_out in cases:
        x, w = ring_inputs(gen, G, n, n * m, k, n_out)
        y = cm.matmul_reduce_scatter(x, w)
        torch.cuda.synchronize()
        err, ratio, row = hold_ring(f"matmul_reduce_scatter {label}", y,
                                    cm.matmul_reduce_scatter_ref(x, w))
        errs.setdefault("matmul_reduce_scatter", err)
        log(f"[ring] matmul_reduce_scatter {label} [G {G}, n {n}, n·m "
            f"{n * m}, K {k}, N {n_out}]: max abs err {err:.4g} (elementwise "
            f"{ratio:.3f} of the tolerance), worst row {row:.3g} -> ok")
        del x, w, y
    for label, shape, dtype in (
            ("path: k/v blocks", (1, 4, 16, 16, 256, 128), torch.bfloat16),
            ("n 2, fp32", (1, 2, 1000, 3), torch.float32),
            ("dp 2, ragged bytes", (2, 4, 33), torch.bfloat16)):
        x = torch.randn(shape, generator=gen, device=gen.device).to(dtype)
        for reverse in (False, True):
            if not torch.equal(cm.ring_shift(x, reverse),
                               cm.ring_shift_ref(x, reverse)):
                fail(f"ring_shift {label}: not the plain shift")
        log(f"[ring] ring_shift {label} {list(shape)}: byte-equal both "
            f"ways -> ok")
    errs["ring_shift"] = 0.0
    # the VJPs: each backward is the other kernel
    for name, fn, ref, rows in (
            ("AllGatherMatmul", cm.AllGatherMatmul, cm.all_gather_matmul_ref,
             1024), ("MatmulReduceScatter", cm.MatmulReduceScatter,
                     cm.matmul_reduce_scatter_ref, 4096)):
        x, w = ring_inputs(gen, 2, 4, rows, 512, 256)
        w0 = w[:1].detach().clone()
        xs, ws = x.clone().requires_grad_(), w0.clone().requires_grad_()
        out = fn.apply(xs, ws.expand(2, -1, -1, -1))
        g = torch.randn(out.shape, generator=gen, device=gen.device).to(
            torch.bfloat16)
        got = torch.autograd.grad(out, (xs, ws), g)
        xr, wr = x.clone().requires_grad_(), w0.clone().requires_grad_()
        plain = ref(xr, wr.expand(2, -1, -1, -1))
        plain = plain[0] if isinstance(plain, tuple) else plain
        want = torch.autograd.grad(plain, (xr, wr), g)
        for part, a, b in zip(("dx", "dw"), got, want):
            err = float((a.float() - b.float()).norm() / b.float().norm())
            log(f"[ring] {name} {part} against autograd through the plain "
                f"version: relative L2 {err:.3g} (tolerance {VJP_REL})")
            if not err <= VJP_REL:
                fail(f"{name} {part}: relative L2 {err} > {VJP_REL}")
    x = torch.randn((1, 4, 8, 1024), generator=gen, device=gen.device).to(
        torch.bfloat16).requires_grad_()
    g = torch.randn_like(x)
    (d,) = torch.autograd.grad(cm.RingShift.apply(x, False), x, g)
    if not torch.equal(d, cm.ring_shift_ref(g, True)):
        fail("RingShift: the cotangent did not shift back")
    log("[ring] RingShift: the cotangent shifts the other way, byte-equal "
        "-> ok")
    log(f"[ring] tolerances: y elementwise rtol = atol = {cm.ELEM_TOL}, per "
        f"row {cm.ROW_TOL}; gathered operand and shift byte-equal; VJPs "
        f"{VJP_REL} relative L2")
    return errs


def time_ring(gen) -> dict:
    """Phase 12: each ring kernel alone (its C entries with prepared
    arguments, n launches for a matmul), through its wrapper, its plain
    version and a library yardstick, with CUDA events, at the path's
    shapes.  Bounds: operands read once; outputs written once; the n − 1
    ring copies read once more (the gathered slots at the next step, the
    reduce-scatter's fp32 partials written and read); 2 FLOP per
    multiply-add."""
    import torch

    from tpu_dra_torch.kernels.build import library
    from tpu_dra_torch.workloads import collective_matmul as cm
    lib = library("ring")
    stream = torch.cuda.current_stream().cuda_stream
    P = lambda t: t.data_ptr()      # noqa: E731

    def checked(rc):
        if rc:
            fail(f"ring kernel launch failed with CUDA error {rc}")
    times = {}
    for label, m, k, n_out in (("wqkv", 4096, 2048, 1536),
                               ("w1", 4096, 2048, 2048)):
        n = 4
        x, w = ring_inputs(gen, 1, n, m, k, n_out)
        y = torch.empty((1, n, n * m, n_out), dtype=torch.bfloat16,
                        device=x.device)
        a = torch.empty((1, n, n, m, k), dtype=torch.bfloat16, device=x.device)

        def kernel():
            for step in range(n):
                checked(lib.tpu_dra_ring_ag_matmul(
                    P(x), P(w), P(y), P(a), 1, n, m, k, n_out, m * k,
                    n * m * k, w.stride(1), 0, step, 1, stream))
        gathered = x.reshape(1, n * m, k)
        wl = w[0]
        times[f"all_gather_matmul {label}"] = {
            "ms": cuda_time_ms(kernel, 20),
            "wrapper_ms": cuda_time_ms(lambda: cm.all_gather_matmul(x, w), 20),
            "plain_ms": cuda_time_ms(lambda: cm.all_gather_matmul_ref(x, w), 3,
                                     warmup=1),
            "library_ms": cuda_time_ms(lambda: torch.matmul(gathered, wl), 20),
            "library": "one batched torch.matmul of the gathered x against "
                       "the stacked w",
            **flash_bound(
                2 * (n * m * k + n * k * n_out + n * n * m * n_out
                     + n * n * m * k + (n - 1) * n * m * k),
                2 * n * (n * m) * k * n_out)}
        del x, w, y, a, gathered
    for label, m, k, n_out in (("w2", 4096, 2048, 2048),
                               ("wo", 4096, 512, 2048)):
        n = 4
        x, w = ring_inputs(gen, 1, n, n * m, k, n_out)
        y = torch.empty((1, n, m, n_out), dtype=torch.bfloat16,
                        device=x.device)
        comm = torch.empty((1, n, 2, m, n_out), dtype=torch.float32,
                           device=x.device)

        def kernel():
            for step in range(n):
                checked(lib.tpu_dra_ring_matmul_rs(
                    P(x), P(w), P(comm), P(y), 1, n, m, k, n_out, n * m * k,
                    n * n * m * k, w.stride(1), 0, step, stream))
        xl, wl = x[0], w[0]
        times[f"matmul_reduce_scatter {label}"] = {
            "ms": cuda_time_ms(kernel, 20),
            "wrapper_ms": cuda_time_ms(
                lambda: cm.matmul_reduce_scatter(x, w), 20),
            "plain_ms": cuda_time_ms(
                lambda: cm.matmul_reduce_scatter_ref(x, w), 3, warmup=1),
            "library_ms": cuda_time_ms(lambda: torch.matmul(xl, wl).reshape(
                n, n, m, n_out).sum(0), 20),
            "library": "two calls: torch.matmul, then the sum over ranks",
            **flash_bound(
                2 * (n * n * m * k + n * k * n_out + n * m * n_out)
                + 2 * 4 * (n - 1) * n * m * n_out,
                2 * n * (n * m) * k * n_out)}
        del x, w, y, comm
    x = torch.randn((1, 4, 16, 16, 256, 128), generator=gen,
                    device=gen.device).to(torch.bfloat16)
    out = torch.empty_like(x)
    per_rank = x[0, 0].numel() * 2
    times["ring_shift k/v block"] = {
        "ms": cuda_time_ms(lambda: checked(lib.tpu_dra_ring_shift(
            P(x), P(out), 1, 4, per_rank, 1, stream)), 50),
        "wrapper_ms": cuda_time_ms(lambda: cm.ring_shift(x), 50),
        "plain_ms": cuda_time_ms(lambda: cm.ring_shift_ref(x), 20),
        "library_ms": cuda_time_ms(lambda: torch.roll(x, 1, dims=1), 50),
        "library": "torch.roll",
        **flash_bound(2 * x.numel() * 2, 0)}
    return times


# ---------------------------------------------------------------------------
# phases 13-14: DP×TP fused collective and DP×SP ring flash training
# ---------------------------------------------------------------------------

def leaf_updates(old: dict, new: dict, scale: float) -> dict:
    """``(old − new) / scale`` per leaf of two parameter trees (the
    gradient an SGD step applied, for scale = lr)."""
    return {k: (leaf_updates(v, new[k], scale) if isinstance(v, dict)
                else (v - new[k]) / scale) for k, v in old.items()}


def window_batches(data_path: str, batch: int, seq: int, count: int):
    import torch

    from tpu_dra_torch.workloads.data import TokenDataset, batches
    it = batches(TokenDataset(data_path), batch=batch, seq=seq)
    return [torch.from_numpy(next(it)).to("cuda") for _ in range(count)]


def train_loop(label: str, step, params, windows, counters: dict,
               must_fall: bool = True) -> dict:
    """``step(params, window)`` over ``windows`` with the kernels' launch
    counts zeroed just before and read just after; fails unless every loss
    is finite and (``must_fall``) the last below the first."""
    import math

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, stamps = [], []
    t0 = time.perf_counter()
    for win in windows:
        params, loss = step(params, win)
        losses.append(float(loss))
        stamps.append(time.perf_counter())
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {label} losses by step: "
        f"{', '.join(repr(x) for x in losses)}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: losses {losses}")
    if must_fall and not losses[-1] < losses[0]:
        fail(f"{label}: loss did not fall: {losses}")
    times = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    step_s = statistics.median(times[1:])
    return {"launches": launches, "losses": losses, "step_ms": 1e3 * step_s,
            "first_ms": 1e3 * times[0], "peak_gb": peak_gb,
            "params": params}


def sharded_phase(gen, data_path: str) -> dict:
    """Phase 13: ``make_sharded_train_step`` on Mesh({"dp": 1, "tp": 4})
    with flash attention and matmul_impl="fused_collective": one step
    against the same mesh's dense step (loss within STEP_LOSS_ATOL, every
    gradient leaf, read off an SGD step at lr 1 as p − p', within
    STEP_LEAF_REL), then SHARDED_RUN steps at SGD_LR on [16, 1025]
    windows with finite, falling losses and exactly 4·L·n gather and
    4·L·n reduce-scatter launches a step (4·L calls of each: the forward's
    two, and each one's backward through the other; n = 4 launches a
    call; no remat), then the dense sharded step's time beside it and one
    profiled step."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.train import (ModelConfig, init_params,
                                               make_sharded_train_step,
                                               tree_leaves)
    cfg = ModelConfig(**TRAIN_MODEL)
    mesh = Mesh({"dp": 1, "tp": 4})
    n, L, batch = 4, cfg.n_layers, SHARDED_RUN["batch"]
    windows = window_batches(data_path, batch, cfg.max_seq,
                             SHARDED_RUN["steps"] + 1)
    params = init_params(cfg, gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    grads = {}
    for impl in ("fused_collective", "dense"):
        step, _, _ = make_sharded_train_step(
            cfg, mesh, lr=1.0, attn_impl="flash", matmul_impl=impl)
        new, loss = step(params, windows[0])
        grads[impl] = (loss, leaf_updates(params, new, 1.0))
        del new
    hold_step("DP×TP tp 4", "fused-collective step vs the dense sharded "
              "step", *grads["fused_collective"], *grads["dense"])
    del grads
    counters = {"all_gather_matmul": cm.all_gather_matmul,
                "matmul_reduce_scatter": cm.matmul_reduce_scatter,
                "flash_fwd": F.flash_attn_fwd, "flash_bwd_dq": F.flash_bwd_dq,
                "flash_bwd_dkdv": F.flash_bwd_dkdv}
    step, _, _ = make_sharded_train_step(cfg, mesh, lr=SGD_LR,
                                         attn_impl="flash",
                                         matmul_impl="fused_collective")
    steps = SHARDED_RUN["steps"]
    run = train_loop("DP×TP fused collective", step, params,
                     windows[1:], counters)
    want = {"all_gather_matmul": 4 * L * n * steps,
            "matmul_reduce_scatter": 4 * L * n * steps,
            "flash_fwd": L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkdv": L * steps}
    if run["launches"] != want:
        fail(f"DP×TP fused collective: launches {run['launches']}, "
             f"expected {want}")
    dense_step, _, _ = make_sharded_train_step(cfg, mesh, lr=SGD_LR,
                                               attn_impl="flash")
    dense = train_loop("DP×TP dense (plain collectives, informational)",
                       dense_step, params, windows[1:], {}, must_fall=False)
    tok_step = batch * cfg.max_seq
    for label, r in (("fused collective", run), ("dense", dense)):
        log(f"[train] DP×TP {label}, tp 4 on one card: step "
            f"{r['step_ms']:.1f} ms (median of steps 2-{len(r['losses'])}; "
            f"first {r['first_ms']:.1f} ms), steady "
            f"{tok_step / r['step_ms'] * 1e3:.0f} tokens/s, "
            f"6·N·tokens/time/989e12 = "
            f"{6 * n_params * tok_step / r['step_ms'] * 1e3 / BF16_FLOPS_PER_S:.3f}"
            f", peak memory {r['peak_gb']:.1f} GB (informational)")
    log(f"[train] DP×TP fused collective: launches over {steps} steps "
        f"{run['launches']} (exact: 4·L·n per matmul kernel, L per flash "
        f"kernel a step)")
    state = {"p": run["params"]}

    def one():
        state["p"], _ = step(state["p"], windows[-1])
    prof = profile_call("DP×TP fused-collective train step", one)
    if prof:
        ring_us = prof.get(kernel_kind("ring_"), 0.0)
        log(f"[train] DP×TP fused collective, one traced step: ring kernels "
            f"{ring_us / 1e3:.1f} ms of {prof['busy'] / 1e3:.1f} ms device "
            f"busy ({ring_us / prof['busy']:.3f}), wall "
            f"{prof['wall'] / 1e3:.1f} ms, idle share "
            f"{1 - prof['busy'] / prof['wall']:.3f} (before the wgmma "
            f"redesign: ~114 ms of 272.9 ms busy, idle share 0.019)")
    del run["params"], dense["params"], params, state
    torch.cuda.empty_cache()
    return {**run, "dense_step_ms": dense["step_ms"]}


def ring_phase(gen, data_path: str) -> dict:
    """Phase 14: ``make_ring_train_step`` on Mesh({"dp": 1, "sp": 4}) with
    ring_impl="flash": one step with hop_impl="pallas" (the shift kernel)
    bit-equal to hop_impl="xla" (torch.roll), loss and updated parameters;
    the same step against the one-device flash step on the same window
    (loss within STEP_LOSS_ATOL; gradients, the update over lr·n_ranks as
    the reference's summed replica gradients carry the rank count, within
    STEP_LEAF_REL); then SHARDED_RUN steps with finite, falling losses and
    exactly 4·(n − 1)·L shift launches a step (2·(n − 1)·L forward, as
    many backward, no remat), and one profiled step."""
    import torch

    from tpu_dra_torch.workloads import collective_matmul as cm
    from tpu_dra_torch.workloads import flash as F
    from tpu_dra_torch.workloads.mesh import Mesh
    from tpu_dra_torch.workloads.ring_attention import make_ring_train_step
    from tpu_dra_torch.workloads.train import (ModelConfig, grads_fn,
                                               init_params, tree_leaves)
    cfg = ModelConfig(**TRAIN_MODEL)
    n, L, batch = 4, cfg.n_layers, SHARDED_RUN["batch"]
    mesh = Mesh({"dp": 1, "sp": n})
    windows = window_batches(data_path, batch, cfg.max_seq,
                             SHARDED_RUN["steps"] + 1)
    params = init_params(cfg, gen)
    win = windows[0]
    res = {}
    for hop in ("pallas", "xla"):
        step, _ = make_ring_train_step(cfg, mesh, lr=1.0, ring_impl="flash",
                                       hop_impl=hop)
        res[hop] = step(params, win[:, :-1], win[:, 1:])
    (pp, lp), (px, lx) = res["pallas"], res["xla"]
    same = float(lp) == float(lx) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(pp), tree_leaves(px)))
    log(f"[train] DP×SP ring flash, sp {n}: hop_impl=\"pallas\" vs \"xla\": "
        f"loss {float(lp)!r} vs {float(lx)!r}; loss and every updated "
        f"parameter bit-equal: {same}")
    if not same:
        fail("DP×SP: the shift kernel's step is not bit-equal to torch.roll's")
    del px, res
    loss1, g1 = grads_fn(cfg, params, win, attn_impl="flash")
    hold_step(f"DP×SP sp {n}", "ring flash step (update / (lr·n)) vs the "
              "one-device flash step", lp, leaf_updates(params, pp, n),
              loss1, g1)
    del pp, g1
    step, _ = make_ring_train_step(cfg, mesh, lr=SGD_LR, ring_impl="flash",
                                   hop_impl="pallas")
    counters = {"ring_shift": cm.ring_shift, "flash_fwd": F.flash_attn_fwd,
                "flash_bwd_dq": F.flash_bwd_dq,
                "flash_bwd_dkdv": F.flash_bwd_dkdv}
    steps = SHARDED_RUN["steps"]
    run = train_loop("DP×SP ring flash", lambda p, w: step(p, w[:, :-1],
                                                           w[:, 1:]),
                     params, windows[1:], counters)
    want = {"ring_shift": 4 * (n - 1) * L * steps,
            "flash_fwd": n * L * steps, "flash_bwd_dq": n * L * steps,
            "flash_bwd_dkdv": n * L * steps}
    if run["launches"] != want:
        fail(f"DP×SP ring flash: launches {run['launches']}, expected {want}")
    tok_step = batch * cfg.max_seq
    log(f"[train] DP×SP ring flash, sp {n} on one card: step "
        f"{run['step_ms']:.1f} ms (median of steps 2-{steps}; first "
        f"{run['first_ms']:.1f} ms), steady "
        f"{tok_step / run['step_ms'] * 1e3:.0f} tokens/s, peak memory "
        f"{run['peak_gb']:.1f} GB; launches {run['launches']} (exact: "
        f"4·(n−1)·L shifts, n·L of each flash kernel a step; informational "
        f"times)")
    state = {"p": run["params"]}

    def one():
        state["p"], _ = step(state["p"], windows[-1][:, :-1],
                             windows[-1][:, 1:])
    profile_call("DP×SP ring-flash train step", one)
    del run["params"], params, state
    torch.cuda.empty_cache()
    return run


# ---------------------------------------------------------------------------
# phase 15: the quantized products on the card
# ---------------------------------------------------------------------------

# (K, N) of the serving model's matmuls (wqkv, wo, w1, w2, unembed) and the
# rows they see: a decode step at 8 requests, the engine's 32 slots, and a
# prefill of 256 tokens
QUANT_SHAPES = [(1024, 1536), (1024, 1024), (1024, 4096), (4096, 1024),
                (1024, 32768)]
QUANT_ROWS = (8, 32, 256)
# int4 on the card takes bf16 operands with fp32 accumulation, the plain
# version fp32 operands: with bf16 activations every product is exact in
# both, so they part only by the order and rounding of the fp32 sums
# (within 1e-4 of the output's largest magnitude); the STE backward and
# a LoRA adapter over an int8 base round their result to bf16 once
INT4_CARD_REL = 1e-4
BF16_REL = 2 ** -7


def quant_phase(gen) -> dict:
    """Each quantized product on the card against its plain version on
    the CPU (the same inputs): the int8 product through torch._int_mm
    bit-equal (the int32 product alone, and the whole int8_matmul), the
    STE backward, int4 at bf16 operands, LoRA over an int8 base; times
    beside torch.matmul of the bf16 weights, for information."""
    import torch

    from tpu_dra_torch.workloads.quant import (int4_matmul, int8_matmul,
                                               int8_product,
                                               int8_product_ref, matmul_any,
                                               quantize_int4, quantize_int8)

    def cpu(tree):
        return {k: v.cpu() for k, v in tree.items()}

    times = {}
    for K, N in QUANT_SHAPES:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        q8, q4 = quantize_int8(w), quantize_int4(w)
        row_major = q8["q8"].contiguous()          # the layout q8 is not
        wb = w.to(torch.bfloat16)
        for M in QUANT_ROWS:
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            xq = torch.randint(-127, 128, (M, K), generator=gen,
                               device="cuda", dtype=torch.int8)
            exact = int8_product_ref(xq, q8["q8"])
            if not (torch.equal(int8_product(xq, q8["q8"]), exact) and
                    torch.equal(int8_product(xq, row_major), exact)):
                fail(f"int8 product [{M}, {K}] @ [{K}, {N}] differs from "
                     f"its plain version")
            got = int8_matmul(x, q8["q8"], q8["s"])
            want = int8_matmul(x.cpu(), *cpu(q8).values())
            if not torch.equal(got.cpu(), want):
                fail(f"int8_matmul [{M}, {K}] @ [{K}, {N}] is not "
                     f"bit-equal to its plain version")
            got4 = int4_matmul(x, q4["q4"], q4["s4"]).cpu()
            want4 = int4_matmul(x.cpu(), *cpu(q4).values())
            err4 = float((got4 - want4).abs().max())
            if err4 > INT4_CARD_REL * float(want4.abs().max()):
                fail(f"int4_matmul [{M}, {K}] @ [{K}, {N}]: max error "
                     f"{err4:.3g} over {INT4_CARD_REL} of the output")
            times[(M, K, N)] = {
                "int8_matmul": cuda_time_ms(
                    lambda: int8_matmul(x, q8["q8"], q8["s"]), 20),
                "int8_product": cuda_time_ms(
                    lambda: int8_product(xq, q8["q8"]), 20),
                "int8_product_row_major": cuda_time_ms(
                    lambda: int8_product(xq, row_major), 20),
                "int4_matmul": cuda_time_ms(
                    lambda: int4_matmul(x, q4["q4"], q4["s4"]), 20),
                "bf16_matmul": cuda_time_ms(lambda: x @ wb, 20)}
    # the STE backward and LoRA over an int8 base, at wqkv's shape
    K, N = QUANT_SHAPES[0]
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    q8 = quantize_int8(w)
    x = torch.randn((32, K), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((32, N), generator=gen, device="cuda")
    xg = x.clone().requires_grad_(True)
    (int8_matmul(xg, q8["q8"], q8["s"]) * g).sum().backward()
    want = ((g.cpu().double() * q8["s"].cpu().double())
            @ q8["q8"].cpu().double().T)
    err = float((xg.grad.cpu().double() - want).abs().max())
    if err > BF16_REL * float(want.abs().max()):
        fail(f"int8_matmul STE backward: max error {err:.3g}")
    leaf = {"base": q8,
            "a": (torch.randn((K, 16), generator=gen, device="cuda")
                  * K ** -0.5).to(torch.bfloat16),
            "b": (torch.randn((16, N), generator=gen, device="cuda")
                  * 0.25).to(torch.bfloat16),
            "scale": torch.tensor(2.0, device="cuda")}
    got = matmul_any(x, leaf).float().cpu()
    want = matmul_any(x.cpu(), {k: cpu(v) if isinstance(v, dict)
                                else v.cpu() for k, v in leaf.items()})
    err_lora = float((got - want.float()).abs().max())
    if err_lora > BF16_REL * float(want.float().abs().max()):
        fail(f"LoRA over int8: max error {err_lora:.3g}")
    log(f"[quant] the int8 product through torch._int_mm is bit-equal to "
        f"its plain version at every shape ({len(QUANT_SHAPES)} weights x "
        f"rows {QUANT_ROWS}); int4 within {INT4_CARD_REL} of each output; "
        f"STE backward max error {err:.3g}, LoRA over int8 {err_lora:.3g}")
    return times


def log_quant_times(times: dict, card: str) -> None:
    for (M, K, N), t in times.items():
        log(f"[time] [{M}, {K}] @ [{K}, {N}]: int8_matmul "
            f"{t['int8_matmul'] * 1e3:.2f} us (its int32 product "
            f"{t['int8_product'] * 1e3:.2f} us; with a row-major weight "
            f"{t['int8_product_row_major'] * 1e3:.2f} us), int4_matmul "
            f"{t['int4_matmul'] * 1e3:.2f} us, torch.matmul of the bf16 "
            f"weights {t['bf16_matmul'] * 1e3:.2f} us (informational); on "
            f"{card}")


# ---------------------------------------------------------------------------
# phase 16: serve the headline configuration with int8 weights
# ---------------------------------------------------------------------------

def slab_oracle(cfg, params, prompt, steps):
    """The port's greedy_decode (the slab decoder) for one request."""
    import torch

    from tpu_dra_torch.workloads.decode import greedy_decode
    return greedy_decode(cfg, params, torch.tensor([prompt], device="cuda"),
                         steps=steps)[0].tolist()


def slab_oracle_logits_at(cfg, params, prompt, tokens, step):
    """greedy_decode's logits at ``step`` when fed its own ``tokens``."""
    import torch

    from tpu_dra_torch.workloads.decode import (_token_logits, init_kv_cache,
                                                prefill)
    cache = init_kv_cache(cfg, 1, cfg.max_seq)
    cache, logits = prefill(cfg, params, cache,
                            torch.tensor([prompt], device="cuda"))
    for i in range(step):
        logits, cache = _token_logits(
            cfg, params, cache, len(prompt) + i,
            torch.tensor([tokens[i]], dtype=torch.int32, device="cuda"))
    return logits[0].float()


def quant_serve_phase(gen) -> dict:
    """The headline configuration (section_paged's model, int8 weights
    from the seed) served through serve() on the slab and on pages; every
    answer held to greedy_decode on the card; the paged run must launch
    the paged-attention kernel n_layers times a decode step, the slab run
    never; both must take the int8 product on every matmul."""
    import torch

    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**MODEL)
    params = quantize_params_int8(init_params(cfg, gen))
    prompts = request_prompts(cfg.vocab)
    wants: dict[int, list] = {}

    def want(i):
        if i not in wants:
            wants[i] = slab_oracle(cfg, params, prompts[i], REQUESTS[i][1])
        return wants[i]

    runs = {}
    for layout, engine in (("slab", dict(slots=32, chunk=8,
                                         kv_layout="slab")),
                           ("paged", ENGINE)):
        label = f"serve int8 {layout}"
        run = serve_requests(label, cfg, params, engine, prompts)
        steps = run["decode_steps"]
        # 4 matmuls a layer and the head a step, plus the prefills
        if run["int8_calls"] < (4 * cfg.n_layers + 1) * steps:
            fail(f"{label}: {run['int8_calls']} int8 products over {steps} "
                 f"decode steps")
        paged_ok = (run["launches"] >= cfg.n_layers * steps
                    if layout == "paged" else run["launches"] == 0)
        if not paged_ok:
            fail(f"{label}: paged attention launched {run['launches']} "
                 f"times over {steps} decode steps")
        log(f"[{label}] {run['int8_calls']} int8 products and "
            f"{run['launches']} paged-attention launches over {steps} "
            f"decode steps")
        hold_answers(label, run["answers"], want,
                     lambda i, w, step: slab_oracle_logits_at(
                         cfg, params, prompts[i], w, step))
        runs[layout] = run
    with torch.no_grad():
        runs["profile"] = profile_decode_steps(cfg, params, gen)
    del params
    torch.cuda.empty_cache()
    return runs


def profile_decode_steps(cfg, params, gen) -> dict:
    """One decode step of each layout at the engine's 32 slots, every
    slot at 256 tokens of context, under torch.profiler (after two
    warm-up steps): device busy time and idle share (informational)."""
    import torch

    from tpu_dra_torch.workloads.decode import _token_logits, init_kv_cache
    from tpu_dra_torch.workloads.paged_kv import (_paged_step,
                                                  init_paged_cache)
    B, ctx, ps = ENGINE["slots"], 256, ENGINE["page_size"]
    token = torch.randint(0, cfg.vocab, (B,), generator=gen, device="cuda",
                          dtype=torch.int32)
    pos = torch.full((B,), ctx, dtype=torch.int32, device="cuda")
    slab = init_kv_cache(cfg, B, cfg.max_seq)
    per_slot = -(-(ctx + 1) // ps)
    pages = init_paged_cache(cfg, B * per_slot, ps, device="cuda")
    table = torch.full((B, cfg.max_seq // ps), -1, dtype=torch.int32,
                       device="cuda")
    table[:, :per_slot] = torch.arange(B * per_slot, dtype=torch.int32,
                                       device="cuda").reshape(B, per_slot)
    steps = {"slab": lambda: _token_logits(cfg, params, slab, pos, token),
             "paged": lambda: _paged_step(cfg, params, pages, token, pos,
                                          table)}
    out = {}
    for layout, step in steps.items():
        for _ in range(2):
            step()
        out[layout] = profile_call(
            f"{layout} decode step (int8 weights, {B} slots at {ctx} "
            f"tokens)", step)
    return out


# ---------------------------------------------------------------------------
# phase 17: speculative serving at full width
# ---------------------------------------------------------------------------

def spec_serve_phase(gen, card: str) -> dict:
    """The int8 serving model with a real draft (tpu_dra_torch.bench's
    section_spec_real settings: 2 layers distilled 150 steps at batch 16,
    seq 256 from the fp32 tree, then int8) served through serve() with
    --speculative-continuous's engine on the slab and on pages, beside
    the plain engine, 32 mixed-length requests at 16 slots, chunk 8.
    Every speculative answer held to the plain engine's of its layout by
    the near-tie rule; on pages the draft's steps must launch the paged
    attention kernel exactly draft layers x chunk times a pass, on the
    slab never; a sampled batch; the draft == target ceiling must accept
    every proposal; one pass of each layout under torch.profiler."""
    import numpy as np
    import torch

    from tpu_dra_torch.bench import LOAD, SPEC_DISTILL, SPEC_ENGINE, SPEC_PAGES
    from tpu_dra_torch.workloads.quant import quantize_params_int8
    from tpu_dra_torch.workloads.spec_draft import (_distill_loss,
                                                    make_draft,
                                                    truncate_draft)
    from tpu_dra_torch.workloads.train import ModelConfig, init_params
    cfg = ModelConfig(**MODEL)
    fparams = init_params(cfg, gen)
    t0 = time.perf_counter()
    dcfg, dfloat = make_draft(cfg, fparams, **SPEC_DISTILL)
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    held = torch.randint(0, cfg.vocab, (8, SPEC_DISTILL["seq"]),
                         generator=gen, device="cuda")
    with torch.no_grad():
        kl = [float(_distill_loss(dcfg, cfg, fparams, d, held))
              for d in (truncate_draft(cfg, fparams, dcfg.n_layers)[1],
                        dfloat)]
    log(f"[spec] draft: {dcfg.n_layers} of {cfg.n_layers} layers distilled "
        f"{SPEC_DISTILL['distill_steps']} steps at batch "
        f"{SPEC_DISTILL['batch']}, seq {SPEC_DISTILL['seq']} in "
        f"{distill_s:.1f} s; KL(target || draft) on a held-out batch "
        f"{kl[0]:.4f} truncated, {kl[1]:.4f} distilled (informational)")
    params = quantize_params_int8(fparams)
    dparams = quantize_params_int8(dfloat)
    del fparams, dfloat
    n = len(LOAD["lengths"])
    reqs = [(LOAD["lengths"][i % n], LOAD["steps"][i % n])
            for i in range(32)]
    rng = np.random.default_rng(SEED + 17)
    prompts = [rng.integers(0, cfg.vocab, ln).tolist() for ln, _ in reqs]
    chunk = SPEC_ENGINE["chunk"]
    logits_at = {"slab": slab_oracle_logits_at, "paged": oracle_logits_at}
    out: dict = {"distill_s": distill_s, "kl": kl}
    for layout, kw in (("slab", {}), ("paged", SPEC_PAGES)):
        engine = dict(kv_layout=layout, **SPEC_ENGINE, **kw)
        plain = serve_requests(f"spec {layout} plain", cfg, params, engine,
                               prompts, reqs)
        spec = serve_requests(
            f"spec {layout}", cfg, params,
            dict(engine, draft=(dcfg, dparams), speculative_engine=True),
            prompts, reqs, sampled=8)
        st = spec["stats"]
        passes = st["spec_target_passes"]
        want = dcfg.n_layers * chunk * passes if layout == "paged" else 0
        if spec["launches"] != want:
            fail(f"spec {layout}: paged attention launched "
                 f"{spec['launches']} times over {passes} speculative "
                 f"passes ({want} wanted)")
        log(f"[spec {layout}] {passes} target passes, accept rate "
            f"{st['spec_accept_rate']}, {st['spec_tokens_per_pass']} tokens "
            f"per slot-pass, paged attention launches {spec['launches']}; "
            f"{spec['tokens_per_s']:.1f} tokens/s against the plain "
            f"engine's {plain['tokens_per_s']:.1f} (informational); on "
            f"{card}")
        hold_answers(f"spec {layout}", spec["answers"],
                     lambda i, a=plain["answers"]: a[i],
                     lambda i, w, step, f=logits_at[layout]: f(
                         cfg, params, prompts[i], w, step), requests=reqs)
        out[layout] = {"plain": plain, "spec": spec}
    # the ceiling: draft == target accepts every proposal on the slab,
    # where the draft's step and the verify chunk round alike; on pages
    # the draft's step attends through the kernel (fp32 scores) and the
    # verify through the chunk path (bf16 scores), so near-ties reject
    # there (informational)
    for layout, kw in (("slab", {}), ("paged", SPEC_PAGES)):
        ceiling = serve_requests(
            f"spec ceiling {layout}", cfg, params,
            dict(kv_layout=layout, **SPEC_ENGINE, **kw, draft=(cfg, params),
                 speculative_engine=True), prompts[:8], reqs[:8])
        rate = ceiling["stats"]["spec_accept_rate"]
        log(f"[spec ceiling {layout}] draft == target: accept rate {rate}, "
            f"{ceiling['stats']['spec_tokens_per_pass']} tokens per "
            f"slot-pass, {ceiling['tokens_per_s']:.1f} tokens/s "
            f"(informational)")
        if layout == "slab" and rate != 1.0:
            fail(f"draft == target accepted {rate} of its proposals, not "
                 f"all")
        out[f"ceiling {layout}"] = ceiling
    with torch.no_grad():
        out["profile"] = profile_spec_pass(cfg, params, dcfg, dparams)
    del params, dparams
    torch.cuda.empty_cache()
    return out


def profile_spec_pass(cfg, params, dcfg, dparams) -> dict:
    """One speculative pass of each layout at 16 slots, every slot at 256
    tokens of context, under torch.profiler after two warm-up passes
    (informational)."""
    import torch

    from tpu_dra_torch.bench import SPEC_ENGINE, SPEC_PAGES
    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    ctx = 256
    out = {}
    for layout, kw in (("slab", {}), ("paged", SPEC_PAGES)):
        eng = ContinuousEngine(cfg, params, draft=(dcfg, dparams),
                               kv_layout=layout, **SPEC_ENGINE, **kw)
        try:
            if eng.pool is not None:
                need = eng.pool.pages_for(ctx + 3 * eng.chunk)
                for slot in range(eng.slots):
                    eng._table[slot] = torch.from_numpy(eng.pool.table_row(
                        eng.pool.alloc(need), eng._mp)).to(eng.device)

            def one_pass():
                eng._pos.fill_(ctx)
                eng._done.fill_(False)
                eng._spec_chunk()
            for _ in range(2):
                one_pass()
            out[layout] = profile_call(
                f"speculative pass on the {layout} (int8 weights, "
                f"{eng.slots} slots at {ctx} tokens, chunk {eng.chunk})",
                one_pass)
        finally:
            eng.shutdown()
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs "
              "one NVIDIA GPU", file=sys.stderr)
        return 2
    if not (HERE / "tpu_dra_torch" / "csrc").is_dir():
        print(f"chip_smoke: no tpu_dra_torch package beside {__file__}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from tpu_dra_torch.kernels.build import build_all
    # fp32 matmuls in full precision (the plain versions compare in fp32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = build_all()
    log(f"[build] {len(built)} sources, one nvcc each in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        log(f"[build] {name}: nvcc {b.seconds:.1f} s -> {b.path.name}")
        for ln in b.log.splitlines():
            if "registers" in ln or "spill" in ln or "wgmma" in ln:
                log(f"[build]   {ln.strip()}")
    check_spills(built["flash_fwd"])
    check_spills(built["ring"])
    # the split backward: the dQ kernel and the fused kernel with DQ = false
    check_spills(built["flash_bwd"], r"flash_bwd_dq_kernel|"
                 r"flash_bwd_fused_kernelILi\d+ELb[01]ELb0E")
    check_spills(built["matmul"])
    check_spills(built["paged_attention"])
    card = nvidia_smi()
    log(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi name, power "
        f"limit:")
    log(card)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    with torch.no_grad():
        # the full-context cases draw from a generator of their own, so
        # that every other phase's inputs come from `gen` as before
        full_gen = torch.Generator(device="cuda")
        full_gen.manual_seed(SEED + 1)
        max_err = check_kernel(gen, full_gen)
        paged_t = {label: time_kernel(gen if B == 32 else full_gen,
                                      MODEL["n_layers"], B, lo, hi)
                   for label, B, lo, hi in PAGED_SHAPES}
    for label, t in paged_t.items():
        log(f"[time] paged_attention at the {label}: a loop of launches "
            f"{t['ms'] * 1e3:.2f} us ({t['bound_ms'] / t['ms']:.3f} of the "
            f"bound, {t['ms'] / t['library_ms']:.2f}x the library call's "
            f"{t['library_ms'] * 1e3:.2f} us); from a CUDA graph "
            f"{t['graph_ms'] * 1e3:.2f} us ({t['bound_ms'] / t['graph_ms']:.3f}"
            f" of the bound, {t['graph_ms'] / t['library_graph_ms']:.2f}x the "
            f"library call's {t['library_graph_ms'] * 1e3:.2f} us); through "
            f"the Python wrapper {t['wrapper_ms'] * 1e3:.2f} us; plain version "
            f"{t['plain_ms'] * 1e3:.2f} us; library call: SDPA over "
            f"pre-gathered K/V, gather excluded; bound "
            f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} ({t['bytes']} B "
            f"at 3.35 TB/s); before the split-page redesign "
            f"{PAGED_BEFORE_US[label]} us; on {card}")
    timing = paged_t[PAGED_SHAPES[0][0]]
    served = serve_phase(gen)
    log(f"[time] paged_attention launches per decoded token: "
        f"{served['launches'] / max(1, served['decode_steps']):.2f}")

    with torch.no_grad():
        flash_err = check_flash(gen)
    flash_t = time_flash(gen, B=16, H=16, Hkv=16)
    log_flash_times("flagship [256, 1024, 128]", flash_t, card)
    log_fwd_summary("flagship [256, 1024, 128]", flash_t["flash_fwd"], card)
    log_fused_summary("flagship [256, 1024, 128]", flash_t, card)
    gqa_t = time_flash(gen, B=8, H=8, Hkv=2)
    log_flash_times("GQA run [64 over 16, 1024, 128]", gqa_t, card)
    log_fwd_summary("GQA run [64 over 16, 1024, 128]", gqa_t["flash_fwd"],
                    card)
    log_fused_summary("GQA run [64 over 16, 1024, 128]", gqa_t, card)
    log_split_summary("flagship [256, 1024, 128]", flash_t, card)
    log_split_summary("GQA run [64 over 16, 1024, 128]", gqa_t, card)
    for causal in (True, False):
        shape = (f"DP×SP block [256, 256, 128] "
                 f"{'causal' if causal else 'full'}")
        block_t = time_flash(gen, B=16, H=16, Hkv=16, S=256, causal=causal)
        log_flash_times(shape, block_t, card)
        log_split_summary(shape, block_t, card)

    with torch.no_grad():
        mm_err = check_matmul(gen)
        mm_t = time_matmul(gen)
    log_times(mm_t, card)
    benched = bench_phase()
    log_matmul_summary(mm_t["matmul 4096^3"], benched, card)
    log_norm_summary(mm_t, card)

    ring_err = check_ring(gen)
    with torch.no_grad():
        ring_t = time_ring(gen)
    log_times(ring_t, card)
    log_ring_summary(ring_t, card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        trained, fused, gqa_run = train_phase(gen, Path(tmp))
        sharded = sharded_phase(gen, str(Path(tmp) / "tokens.bin"))
        ringed = ring_phase(gen, str(Path(tmp) / "tokens.bin"))

    quant_t = quant_phase(gen)
    log_quant_times(quant_t, card)
    quant_served = quant_serve_phase(gen)
    from tpu_dra_torch.bench import section_decode
    decoded = section_decode()
    log(f"[bench] section_decode (greedy slab decode, batch 8, prompt 128, "
        f"256 steps; informational): {json.dumps(decoded)}")
    slab_tps = quant_served["slab"]["tokens_per_s"]
    log(f"[serve] int8 weights: slab {slab_tps:.1f} tokens/s, paged "
        f"{quant_served['paged']['tokens_per_s']:.1f} tokens/s for the 8 "
        f"requests (informational); on {card}")
    spec = spec_serve_phase(gen, card)

    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "tpu_dra_torch/csrc/paged_attention.cu",
        "replaces": "tpu_dra/workloads/paged_kv.py:248",
        "launches": served["launches"] + spec["paged"]["spec"]["launches"],
        "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]
    flash_src = {"flash_fwd": ("tpu_dra_torch/csrc/flash_fwd.cu",
                               "tpu_dra/workloads/pallas_kernels.py:151"),
                 "flash_bwd_dq": ("tpu_dra_torch/csrc/flash_bwd.cu",
                                  "tpu_dra/workloads/pallas_kernels.py:367"),
                 "flash_bwd_dkdv": ("tpu_dra_torch/csrc/flash_bwd.cu",
                                    "tpu_dra/workloads/pallas_kernels.py:453")}
    for name, (source, replaces) in flash_src.items():
        t = flash_t[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": trained["launches"][name],
            "max_abs_err": flash_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # row #4: the same kernel at g = 4, timed and launched in the GQA run
    t = gqa_t["flash_fwd"]
    kernels.append({
        "name": "flash_fwd_gqa", "route": "cuda",
        "source": "tpu_dra_torch/csrc/flash_fwd.cu",
        "replaces": "tpu_dra/workloads/pallas_kernels.py:221",
        "launches": gqa_run["launches"]["flash_fwd"],
        "max_abs_err": flash_err["flash_fwd_gqa"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    wqkv = next(k for k in mm_t if "wqkv" in k)
    later = {  # name: (source, replaces, launches, max abs err, times)
        "matmul": ("tpu_dra_torch/csrc/matmul.cu",
                   "tpu_dra/workloads/pallas_kernels.py:57",
                   benched["launches"], mm_err["matmul"],
                   mm_t["matmul 4096^3"]),
        "rmsnorm_matmul": ("tpu_dra_torch/csrc/matmul.cu",
                           "tpu_dra/workloads/pallas_kernels.py:863",
                           fused["launches"]["rmsnorm_matmul"],
                           mm_err["rmsnorm_matmul"], mm_t[wqkv]),
        "flash_bwd_fused": ("tpu_dra_torch/csrc/flash_bwd.cu",
                            "tpu_dra/workloads/pallas_kernels.py:494",
                            fused["launches"]["flash_bwd_fused"],
                            flash_err["flash_bwd_fused"],
                            flash_t["flash_bwd_fused"])}
    later.update({
        "all_gather_matmul": ("tpu_dra_torch/csrc/ring.cu",
                              "tpu_dra/workloads/pallas_kernels.py:1058",
                              sharded["launches"]["all_gather_matmul"],
                              ring_err["all_gather_matmul"],
                              ring_t["all_gather_matmul wqkv"]),
        "matmul_reduce_scatter": ("tpu_dra_torch/csrc/ring.cu",
                                  "tpu_dra/workloads/pallas_kernels.py:1165",
                                  sharded["launches"]["matmul_reduce_scatter"],
                                  ring_err["matmul_reduce_scatter"],
                                  ring_t["matmul_reduce_scatter w2"]),
        "ring_shift": ("tpu_dra_torch/csrc/ring.cu",
                       "tpu_dra/workloads/pallas_kernels.py:1313",
                       ringed["launches"]["ring_shift"], ring_err["ring_shift"],
                       ring_t["ring_shift k/v block"])})
    for name, (source, replaces, launches, err, t) in later.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
