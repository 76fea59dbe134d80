#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpu_dra_torch``) on one NVIDIA
GPU: builds its CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version, times it, then serves the
full-width headline model through the port's HTTP server and checks the
answers against the port's own per-request decoder.

    python3 chip_smoke.py            # needs one CUDA card; no arguments

Phases (each prints as it goes; any failed check exits non-zero):
  1. build the kernel (nvcc); print the build time and the card's name
     and power limit (nvidia-smi);
  2. paged attention: kernel vs plain version at the serving path's shapes
     (B=32, H=8, Hkv=2, Dh=128, ps=64, MP=16), scrambled pages, -1 tails,
     lengths 0, 1, a page boundary, mid-page and the full MP*ps; bf16 pages
     within rtol/atol 0.05, int8 pages within 0.08 (the reference's own
     kernel-vs-oracle tolerances, tests/test_paged_kv.py), and every slot
     within paged_kv.SLOT_REL_TOL relative L2 error;
  3. time the kernel, the plain version and a library yardstick with CUDA
     events at one decode step of a full 160-page pool;
  4. serve: start serve() on port 0 with the full-width model (vocab
     32768, d_model 1024, 8 heads over 2 kv heads, 8 layers, d_ff 4096,
     rope, bf16 weights from a seed), slots 32, chunk 8, page size 64, 160
     pages; POST 8 concurrent greedy /generate requests and check each
     answer against the port's paged_greedy_decode on the card, and that
     the decode went through the kernel (launch counts).
The second-to-last line is a JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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
ENGINE = dict(slots=32, chunk=8, page_size=64, total_pages=160)
SEED = 0
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


def check_kernel(gen) -> float:
    """The kernel against its plain version on the same inputs, twice
    over: elementwise within the reference's rtol/atol, and each slot
    within SLOT_REL_TOL relative L2 error on its own scale (the outputs of
    a long slot are too small for the elementwise bound to bind)."""
    import torch

    from tpu_dra_torch.workloads.paged_kv import (SLOT_REL_TOL,
                                                  paged_attention,
                                                  paged_attention_ref,
                                                  slot_rel_err)
    ps, MP = 64, 16
    specials = [0, 1, ps, ps + 1, 100, MP * ps, 2 * ps - 1, 7 * ps + 33]
    rand = torch.randint(1, MP * ps + 1, (32 - len(specials),),
                         generator=gen, device=gen.device).tolist()
    lengths = specials + rand
    worst = 0.0
    for quantized, tol in ((False, 0.05), (True, 0.08)):
        args, extra = attention_case(gen, lengths, quantized=quantized)
        got = paged_attention(*args, **extra)
        torch.cuda.synchronize()
        want = paged_attention_ref(*args, **extra)
        gf, wf = got.float(), want.float()
        err = float((gf - wf).abs().max())
        ok = bool(torch.all((gf - wf).abs() <= tol + tol * wf.abs()))
        rel = slot_rel_err(got, want)
        b = int(rel.argmax())
        rel_ok = float(rel.max()) <= SLOT_REL_TOL
        if not torch.isfinite(gf).all():
            fail("paged attention kernel produced non-finite values")
        if not bool((gf[0] == 0).all()):
            fail("zero-length slot did not give zeros")
        kind = "int8" if quantized else "bf16"
        log(f"[kernel] paged_attention {kind} pages: max |kernel - plain| "
            f"= {err:.5f} (rtol/atol {tol}) -> {'ok' if ok else 'FAIL'}; "
            f"worst slot relative L2 error {float(rel.max()):.5f} (slot "
            f"{b}, length {lengths[b]}; median {float(rel.median()):.5f}; "
            f"tolerance {SLOT_REL_TOL}) -> {'ok' if rel_ok else 'FAIL'}")
        if not (ok and rel_ok):
            fail(f"paged attention kernel disagrees with its plain version "
                 f"({kind} pages, max abs err {err}, worst slot relative "
                 f"error {float(rel.max())})")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 3: timing at one decode step of a full pool
# ---------------------------------------------------------------------------

def time_kernel(gen, n_layers: int) -> dict:
    """Kernel, plain version and library yardstick at one decode step of
    the served model: 32 slots sharing the full 160-page pool (5 pages
    each, lengths in (256, 320]).  The kernel cycles through ``n_layers``
    distinct layer pools, as one decode step does, so its pages come from
    device memory rather than the 50 MB L2 cache."""
    import torch
    import torch.nn.functional as F

    from tpu_dra_torch.kernels.build import library
    from tpu_dra_torch.workloads.paged_kv import (_LOG2E, paged_attention,
                                                  paged_attention_ref)
    dev = gen.device
    B, H, Hkv, Dh, P, ps, MP = 32, 8, 2, 128, 160, 64, 16
    lengths = torch.randint(4 * ps + 1, 5 * ps + 1, (B,), generator=gen,
                            device=dev, dtype=torch.int32)
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    table = torch.full((B, MP), -1, dtype=torch.int32, device=dev)
    table[:, :5] = perm.reshape(B, 5)
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
    stream = torch.cuda.current_stream().cuda_stream
    layer = [0]

    def kernel():
        i = layer[0] = (layer[0] + 1) % n_layers
        rc = lib.tpu_dra_paged_attention(
            qs.data_ptr(), k_all[i].data_ptr(), v_all[i].data_ptr(), None,
            None, table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, H, Hkv, P, ps, Dh, MP, 0, stream)
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
    S = 5 * ps
    tab = table[:, :5].long()
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

    t = {"ms": cuda_time_ms(kernel, 400),
         "wrapper_ms": cuda_time_ms(wrapper, 200),
         "plain_ms": cuda_time_ms(plain, 40),
         "library_ms": cuda_time_ms(library_call, 200)}
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


def serve_phase(gen) -> dict:
    import numpy as np
    import torch

    from tpu_dra_torch.workloads.paged_kv import paged_attention
    from tpu_dra_torch.workloads.quant import cast_params_bf16
    from tpu_dra_torch.workloads.serve import serve
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

    srv = serve(cfg, params, port=0, **ENGINE)
    try:
        port = srv.server_address[1]
        post(port, {"tokens": [[1, 2, 3]], "steps": 2})   # first-use costs
        srv.engine.reset_stats()
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab, n).tolist()
                   for n, _ in REQUESTS]
        results: dict[int, object] = {}
        lat: dict[int, float] = {}

        def client(i):
            t = time.perf_counter()
            try:
                results[i] = post(port, {"tokens": [prompts[i]],
                                         "steps": REQUESTS[i][1]})
            except Exception as exc:  # noqa: BLE001 — reported below
                results[i] = exc
            lat[i] = time.perf_counter() - t

        paged_attention.launches = 0
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(REQUESTS))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        launches = paged_attention.launches
        stats = srv.engine.stats()
    finally:
        srv.shutdown()
    answers = []
    for i, (n, steps) in enumerate(REQUESTS):
        res = results.get(i)
        if not isinstance(res, dict):
            fail(f"request {i} failed: {res!r}")
        toks = res["tokens"][0]
        if len(toks) != steps or not all(0 <= t < cfg.vocab for t in toks):
            fail(f"request {i}: {len(toks)} tokens for {steps} steps")
        answers.append(toks)
    n_tok = sum(len(a) for a in answers)
    decode_steps = stats["decode_steps"]
    log(f"[serve] {len(REQUESTS)} concurrent requests, {n_tok} tokens in "
        f"{wall:.3f} s: {n_tok / wall:.1f} tokens/s, p50 latency "
        f"{1e3 * statistics.median(lat.values()):.1f} ms (informational)")
    log(f"[serve] kernel launches {launches} over {decode_steps} decode "
        f"steps: {launches / max(1, decode_steps):.2f} per decoded token "
        f"(n_layers = {cfg.n_layers})")
    if launches < cfg.n_layers * decode_steps or \
            decode_steps < max(s for _, s in REQUESTS) - 1:
        fail(f"paged attention kernel launched {launches} times for "
             f"{decode_steps} decode steps of {cfg.n_layers} layers")

    # each answer against the port's per-request decoder on the card
    compared = 0
    with torch.no_grad():
        for i, ((n, steps), toks) in enumerate(zip(REQUESTS, answers)):
            want = oracle(cfg, params, prompts[i], steps)
            diff = next((j for j, (a, b) in enumerate(zip(toks, want))
                         if a != b), None)
            if diff is None:
                compared += steps
                log(f"[serve] request {i} (prompt {n}, steps {steps}): "
                    f"equals the oracle")
                continue
            lg = oracle_logits_at(cfg, params, prompts[i], want, diff)
            top2 = torch.topk(lg, 2).values.tolist()
            margin, tol = top2[0] - top2[1], argmax_tol(top2[0])
            compared += diff
            log(f"[serve] request {i} (prompt {n}, steps {steps}): equals "
                f"the oracle for {diff} tokens; at step {diff} the oracle's "
                f"top-2 margin is {margin:.4f} (tolerance {tol:.4f})")
            if margin > tol:
                fail(f"request {i} departs from the oracle at step {diff} "
                     f"where the oracle's margin {margin:.4f} > {tol:.4f}")
    log(f"[serve] {compared} of {n_tok} served tokens compared equal to "
        f"the oracle before any near-tie")
    return {"launches": launches, "decode_steps": decode_steps,
            "tokens_per_s": n_tok / wall,
            "p50_latency_ms": 1e3 * statistics.median(lat.values())}


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
    from tpu_dra_torch.kernels.build import build
    # fp32 matmuls in full precision (the plain versions compare in fp32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    b = build("paged_attention")
    log(f"[build] paged_attention: nvcc {b.seconds:.1f} s -> {b.path.name}")
    for ln in b.log.splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"[build]   {ln.strip()}")
    card = nvidia_smi()
    log(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi name, power "
        f"limit:")
    log(card)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    with torch.no_grad():
        max_err = check_kernel(gen)
        timing = time_kernel(gen, MODEL["n_layers"])
    log(f"[time] paged_attention kernel {timing['ms'] * 1e3:.2f} us "
        f"(through the Python wrapper {timing['wrapper_ms'] * 1e3:.2f} us), "
        f"plain version {timing['plain_ms'] * 1e3:.2f} us, library "
        f"yardstick (SDPA over pre-gathered K/V, gather excluded) "
        f"{timing['library_ms'] * 1e3:.2f} us; bound "
        f"{timing['bound_ms'] * 1e3:.2f} us by {timing['bound_by']} "
        f"({timing['bytes']} B at 3.35 TB/s) on {card}")
    served = serve_phase(gen)
    log(f"[time] paged_attention launches per decoded token: "
        f"{served['launches'] / max(1, served['decode_steps']):.2f}")

    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "tpu_dra_torch/csrc/paged_attention.cu",
        "replaces": "tpu_dra/workloads/paged_kv.py:248",
        "launches": served["launches"], "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
