"""Benchmark sections of the port, the counterparts of ``bench.py``'s.

- :func:`section_probe`: the card, its peak and one product;
- :func:`section_matmul`: ``torch.matmul``'s bf16 throughput at 4096³;
- :func:`section_pallas_matmul`: the tiled-matmul kernel's throughput;
- :func:`section_flash`: the flash forward, forward + backward and the
  grouped forward at BH 8, S 4096, D 128;
- :func:`section_train`: trained tokens/s and MFU of the flagship's
  step (headline, chunked head, fused RMSNorm-matmul, S = 4096);
- :func:`section_decode`, :func:`section_decode_long`: greedy slab decode
  tokens/s of the serving model over bf16, int8 and int4 weights, GQA,
  an int8 KV cache and a 256-slot window;
- :func:`section_continuous`, :func:`section_paged`: the continuous
  engine under a mixed-length load of concurrent requests (slab, and
  paged with a pool a third of the slab's size), int8 weights: tokens/s
  and p50/p95 request latency; then the speculative engine's ceiling
  (draft == target, every proposal accepted) under a third of the load:
  tokens/s and tokens per pass (``*_spec_ceiling_*``,
  ``*_spec_tokens_per_pass``, the reference's keys);
- :func:`section_spec_real`: a real draft (the serving model truncated
  to 2 layers and distilled 150 steps) served speculatively on the slab
  and on pages beside the plain engine: tokens/s, accept rate, tokens
  per pass;
- :func:`section_visibility`: a child process given one card through
  ``CUDA_VISIBLE_DEVICES`` sees exactly that one;
- :func:`section_multiprocess`: two processes on one card at once, each
  under half its memory through ``launcher.apply_hbm_limits``;
- :func:`section_collectives`: the collective bandwidths over the
  process's ``torch.distributed`` group, skipped in a group of one (the
  reference's "single device").

They run in the reference's order (``bench.py:1428-1433``), the probe
first, collectives last.  A section measures the card: it raises where
CUDA is absent instead of timing the CPU, and records the card's name and
power limit (as ``nvidia-smi`` prints them) beside its numbers (the
collectives section measures its group's buffers where they live, and
says where: a gloo group's are in host memory).

    python -m tpu_dra_torch.bench [SECTION ...]   # prints one JSON line
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from tpu_dra_torch.device import resolve_device
from tpu_dra_torch.workloads.quant import (
    cast_params_bf16,
    quantize_params_int4,
    quantize_params_int8,
)
from tpu_dra_torch.workloads.train import (ModelConfig, init_params,
                                           tree_leaves)

# NVIDIA's data-sheet dense bf16 peak of one H100 SXM
H100_BF16_FLOPS = 989e12

# the decode sections' model (bench.py _decode_env on a TPU): learned
# positions, full attention heads; and their batch, prompt and steps
DECODE_MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8,
                    d_ff=4096, max_seq=1024)
DECODE_RUN = dict(B=8, S=128, steps=256)
# the headline serving model of the engine sections: GQA, rope
SERVING_MODEL = dict(vocab=32768, d_model=1024, n_heads=8, n_kv_heads=2,
                     n_layers=8, d_ff=4096, max_seq=1024, pos_emb="rope")
# their request mix: prompt lengths and steps cycle over the requests
LOAD = dict(lengths=[16, 32, 64, 128], steps=[32, 64, 96, 128])
# the real draft of section_spec_real (bench.py:778): quarter depth,
# distilled at batch 16 on 256-token sequences; and its engine
SPEC_DISTILL = dict(n_layers=2, distill_steps=150, batch=16, seq=256)
SPEC_ENGINE = dict(slots=16, chunk=8)
SPEC_PAGES = dict(page_size=64, total_pages=320)
# section_train's flagship (bench.py:195) and its batch; the long arm's
# sequence and batch
TRAIN_MODEL = dict(vocab=32768, d_model=2048, n_heads=16, n_layers=8,
                   d_ff=8192, max_seq=1024)
TRAIN_BATCH = 16
TRAIN_LONG = dict(seq=4096, batch=2)
# section_flash's shape: [1, BH, S, D] bf16, and the GQA arm's q heads
# per kv head
FLASH_SHAPE = dict(bh=8, s=4096, d=128, group=4)
# the root of the checkout, for the child processes' imports
ROOT = Path(__file__).resolve().parent.parent


def card_info(dev: torch.device) -> dict:
    """The card's name, and its name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"device": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi.stdout.strip()}


def mfu_pct(tflops: float) -> float:
    """``tflops`` as a share of the card's 989 TF/s bf16 peak, in %."""
    return round(100.0 * tflops * 1e12 / H100_BF16_FLOPS, 2)


def time_op(fn, x, iters: int, repeats: int = 5) -> float:
    """Seconds of one application of the shape-preserving ``fn``, as the
    reference's ``collectives._time_op`` measures it: ``fn`` chained
    ``iters`` and ``2·iters`` times on ``x``, each run ended by reading a
    scalar of its result back to the host, the best of ``repeats`` runs
    of each, and their difference over ``iters`` (the constant cost of
    starting a run and of the readback drops out).  Where the reference
    runs the chain as one compiled loop, a CUDA tensor's chain is
    captured into one CUDA graph of ``iters`` (and ``2·iters``)
    applications and replayed, so the Python wrappers' host time per
    call stays out of it as it does there; a CPU tensor's runs eagerly.
    One run warms up first.  Raises ``RuntimeError`` if a chain's result
    is not finite, or if the longer chain did not take longer (no time
    can be read from the pair)."""
    def chain(n: int):
        out = x
        for _ in range(n):
            out = fn(out)
        return out

    def runner(n: int):
        if not x.is_cuda:
            return lambda: float(chain(n).float().sum())
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            chain(1)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = chain(n).float().sum()

        def replay():
            graph.replay()
            return float(out)
        return replay

    def best(run) -> float:
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            total = run()
            times.append(time.perf_counter() - t0)
            if not math.isfinite(total):
                raise RuntimeError(f"the chained op's result is not "
                                   f"finite: {total}")
        return min(times)

    run1 = runner(iters)
    run1()
    t1 = best(run1)
    del run1
    run2 = runner(2 * iters)
    run2()
    t2 = best(run2)
    del run2
    if t2 <= t1:
        raise RuntimeError(f"{2 * iters} applications took {t2} s, no "
                           f"longer than {iters} took ({t1} s)")
    return (t2 - t1) / iters


def section_probe() -> dict:
    """The card the port sees (``bench.py:90``): device count, platform,
    name, the bf16 peak MFU is taken against, and a 256² bf16 product
    whose sum must be finite (the compute path, not just enumeration)."""
    dev = resolve_device()
    x = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
    out = {"gpu_devices": torch.cuda.device_count(),
           "gpu_platform": "gpu",
           "gpu_device_kind": torch.cuda.get_device_name(dev),
           "gpu_peak_bf16_tflops": H100_BF16_FLOPS / 1e12,
           "probe_matmul_ok": bool(torch.isfinite((x @ x).float().sum()))}
    out.update(card_info(dev))
    return out


def matmul_numbers(device, mm, prefix: str, n: int = 4096,
                   iters: int = 100) -> dict:
    """``mm`` on ``[n, n] @ [n, n]`` bf16 (seed 0), the op ``x ← mm(x,
    b)·(1/n)`` timed by :func:`time_op` (the reference's
    ``collectives.matmul_throughput``): ``<prefix>_tflops`` at 2n³ an op
    and ``<prefix>_mfu_pct``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)
    inv = float(torch.tensor(1.0 / n, dtype=torch.bfloat16))
    secs = time_op(lambda x: mm(x, b) * inv, a, iters)
    tflops = 2 * n ** 3 / secs / 1e12
    return {f"{prefix}_tflops": round(tflops, 2),
            f"{prefix}_mfu_pct": mfu_pct(tflops)}


def section_matmul() -> dict:
    """The library's bf16 matmul at 4096³ (``bench.py:110``):
    ``gpu_matmul_*`` of :func:`matmul_numbers` through ``torch.matmul``,
    the op :func:`section_pallas_matmul` times through the kernel."""
    dev = resolve_device()
    out = matmul_numbers(dev, torch.matmul, "gpu_matmul")
    out.update(card_info(dev))
    return out


def section_pallas_matmul() -> dict:
    """``matmul.matmul`` (row #2, ``csrc/matmul.cu``) at 4096³:
    ``pallas_matmul_*`` of :func:`matmul_numbers`, timed as
    :func:`section_matmul` times ``torch.matmul``."""
    from tpu_dra_torch.workloads.matmul import matmul
    dev = resolve_device()
    out = matmul_numbers(dev, matmul, "pallas_matmul")
    out.update(card_info(dev))
    return out


def decode_seconds(cfg: ModelConfig, *, quant=cast_params_bf16,
                   cache_dtype: str = "bf16", B: int, S: int, steps: int,
                   window: int | None = None, device, reps: int = 3) -> float:
    """Best wall time of ``reps`` greedy decodes of ``steps`` tokens after
    a ``[B, S]`` prompt (one warm-up first), each ended by a readback of
    its last token: weights ``quant(init_params(seed 0))``, prompt from
    seed 1, the cache sized to the live sequence (or ``window`` slots)."""
    from tpu_dra_torch.workloads.decode import make_decoder
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = quant(init_params(cfg, gen))
    gen.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device)
    dec = make_decoder(cfg, steps=steps,
                       max_len=None if window else S + steps,
                       cache_dtype=cache_dtype, window=window, device=device)

    def run():
        int(dec(params, prompt)[0, -1])

    run()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def _rates(out: dict, key: str, secs: float, B: int, steps: int) -> None:
    out[f"{key}_tokens_per_s"] = round(B * steps / secs, 1)
    out[f"{key}_ms_per_token"] = round(secs / steps * 1e3, 3)


def section_decode() -> dict:
    """Greedy slab decode of the serving model at batch 8, prompt 128,
    256 steps (host clock, best of 3): bf16, int8 and int4 weights, each
    with full heads and with GQA (kv heads = heads / 4), and int8 + GQA at
    batch 32."""
    dev = resolve_device()
    cfg = ModelConfig(**DECODE_MODEL)
    gqa = dataclasses.replace(cfg, n_kv_heads=cfg.n_heads // 4)
    B, S, steps = DECODE_RUN["B"], DECODE_RUN["S"], DECODE_RUN["steps"]
    out: dict = {"decode_steps": steps, "decode_batch": B}
    forms = {"": cast_params_bf16, "_int8": quantize_params_int8,
             "_int4": quantize_params_int4}
    for model, tag in ((cfg, ""), (gqa, "_gqa")):
        for form, quant in forms.items():
            secs = decode_seconds(model, quant=quant, B=B, S=S, steps=steps,
                                  device=dev)
            _rates(out, f"decode{form}{tag}", secs, B, steps)
    secs = decode_seconds(gqa, quant=quantize_params_int8, B=32, S=S,
                          steps=steps, device=dev)
    _rates(out, "decode_int8_gqa_b32", secs, 32, steps)
    out.update(card_info(dev))
    return out


def section_decode_long() -> dict:
    """Long-context decode: a 1024-token prompt at batch 8, 256 steps,
    where the cache read dominates: bf16 weights and cache; int8 weights
    and int8 cache; int8 weights and cache over a 256-slot window (rope).
    ``max_seq`` grows to hold the decoded positions."""
    dev = resolve_device()
    cfg = ModelConfig(**DECODE_MODEL)
    B, steps, SL = DECODE_RUN["B"], DECODE_RUN["steps"], 1024
    long_cfg = dataclasses.replace(cfg, max_seq=SL + steps)
    rope_cfg = dataclasses.replace(cfg, pos_emb="rope", max_seq=SL)
    out: dict = {}
    runs = {"decode_long": (long_cfg, cast_params_bf16, "bf16", None),
            "decode_long_full_int8": (long_cfg, quantize_params_int8, "int8",
                                      None),
            "decode_long_window256_int8": (rope_cfg, quantize_params_int8,
                                           "int8", 256)}
    for key, (model, quant, cache_dtype, window) in runs.items():
        secs = decode_seconds(model, quant=quant, cache_dtype=cache_dtype,
                              B=B, S=SL, steps=steps, window=window,
                              device=dev)
        _rates(out, key, secs, B, steps)
    out.update(card_info(dev))
    return out


def serve_load(eng, *, n_req: int, lengths: list[int], steps: list[int],
               timeout: float = 600) -> dict:
    """Warm every prompt bucket of ``eng``, then submit ``n_req`` requests
    at once (prompt ``[7 + i % 100] * lengths[i % ...]``, ``steps[i %
    ...]`` tokens) and wait for all: tokens/s over the wall time, the
    engine's p50/p95 request latency, and the first error if any."""
    for n in lengths:
        eng.submit([1] * n, steps=eng.chunk, timeout=timeout)
    eng.reset_stats()
    reqs = [([7 + i % 100] * lengths[i % len(lengths)],
             steps[i % len(steps)]) for i in range(n_req)]
    t0 = time.perf_counter()
    handles = [eng.submit_async(p, s) for p, s in reqs]
    errs = []
    for h in handles:
        if not h.done.wait(timeout):
            errs.append(f"timeout: request not done within {timeout}s")
        elif h.error:
            errs.append(h.error)
    secs = time.perf_counter() - t0
    stats = eng.stats()
    out = {"tokens_per_s": round(sum(len(h.tokens) for h in handles) / secs,
                                 1),
           "req_p50_ms": stats.get("latency_p50_ms"),
           "req_p95_ms": stats.get("latency_p95_ms")}
    if errs:
        out["errors"] = errs[0][:200]
    return out


def spec_load(eng, **load) -> dict:
    """:func:`serve_load` of a speculative engine, with its accept rate
    and committed tokens per slot-pass."""
    out = serve_load(eng, **load)
    st = eng.stats()
    out["accept_rate"] = st.get("spec_accept_rate")
    out["tokens_per_pass"] = st.get("spec_tokens_per_pass")
    return out


def _engine_section(prefix: str, n_req: int, spec_pages: int | None = None,
                    **engine_kw) -> dict:
    """The mixed load on a plain engine, then the speculative engine's
    ceiling (draft == target) on a third of it (``spec_pages``: the
    doubled pool a paged engine gets for it, as the reference's)."""
    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    dev = resolve_device()
    cfg = ModelConfig(**SERVING_MODEL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = quantize_params_int8(init_params(cfg, gen))
    eng = ContinuousEngine(cfg, params, slots=32, chunk=8, device=dev,
                           **engine_kw)
    try:
        load = serve_load(eng, n_req=n_req, **LOAD)
        out = {f"{prefix}_{k}": v for k, v in load.items()}
        if eng.pool is not None:
            out[f"{prefix}_pool_pages"] = eng.pool.total_pages
            out[f"{prefix}_page_size"] = eng.pool.page_size
            out[f"{prefix}_pool_vs_slab_pct"] = round(
                100.0 * eng.pool.total_pages / (eng.slots * eng._mp), 1)
    finally:
        eng.shutdown()
    if spec_pages is not None:
        engine_kw = dict(engine_kw, total_pages=spec_pages)
    eng = ContinuousEngine(cfg, params, slots=32, chunk=8, device=dev,
                           draft=(cfg, params), **engine_kw)
    try:
        spec = spec_load(eng, n_req=max(4, n_req // 3), **LOAD)
    finally:
        eng.shutdown()
    out[f"{prefix}_spec_ceiling_tokens_per_s"] = spec["tokens_per_s"]
    out[f"{prefix}_spec_tokens_per_pass"] = spec["tokens_per_pass"]
    if "errors" in spec:
        out[f"{prefix}_spec_errors"] = spec["errors"]
    out[f"{prefix}_slots"] = 32
    out[f"{prefix}_requests"] = n_req
    out.update(card_info(dev))
    return out


def section_continuous() -> dict:
    """The continuous engine on the slab: the headline serving model with
    int8 weights, 32 slots, chunk 8, 96 mixed-length requests at once."""
    return _engine_section("continuous", 96, kv_layout="slab")


def section_paged() -> dict:
    """The same load over pages: 64 requests, 64-token pages, a pool of
    160 pages (the worst live need is 128; the slab would hold 512)."""
    return _engine_section("paged", 64, spec_pages=320, kv_layout="paged",
                           page_size=64, total_pages=160)


def section_spec_real() -> dict:
    """A real draft, as the reference's ``section_spec_real``: the
    serving model (fp32 from seed 0) truncated to 2 layers and distilled
    150 steps at batch 16, seq 256 (host clock), then both models int8;
    32 mixed-length requests at 16 slots, chunk 8, through the plain
    engine and the speculative engine on the slab, and the speculative
    engine on 64-token pages (320 pages): tokens/s, accept rate, tokens
    per pass.  The random-init teacher's argmax is a max-entropy
    function, so the accept rate is a floor on a trained model's."""
    from tpu_dra_torch.workloads.continuous import ContinuousEngine
    from tpu_dra_torch.workloads.spec_draft import make_draft
    dev = resolve_device()
    cfg = ModelConfig(**SERVING_MODEL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fparams = init_params(cfg, gen)
    t0 = time.perf_counter()
    dcfg, dfloat = make_draft(cfg, fparams, **SPEC_DISTILL)
    torch.cuda.synchronize(dev)
    out = {"spec_real_draft_layers": dcfg.n_layers,
           "spec_real_target_layers": cfg.n_layers,
           "spec_real_distill_steps": SPEC_DISTILL["distill_steps"],
           "spec_real_distill_secs": round(time.perf_counter() - t0, 1)}
    params = quantize_params_int8(fparams)
    dparams = quantize_params_int8(dfloat)
    del fparams, dfloat
    load = dict(n_req=32, **LOAD)
    runs = {"spec_real_plain": dict(),
            "spec_real": dict(draft=(dcfg, dparams)),
            "paged_spec_real": dict(draft=(dcfg, dparams), kv_layout="paged",
                                    **SPEC_PAGES)}
    for key, kw in runs.items():
        eng = ContinuousEngine(cfg, params, device=dev, **SPEC_ENGINE, **kw)
        try:
            res = spec_load(eng, **load)
        finally:
            eng.shutdown()
        out[f"{key}_tokens_per_s"] = res["tokens_per_s"]
        if "draft" in kw:
            out[f"{key}_accept_rate"] = res["accept_rate"]
            out[f"{key}_tokens_per_pass"] = res["tokens_per_pass"]
        if "errors" in res:
            out[f"{key}_errors"] = res["errors"]
    out["spec_real_speedup_pct"] = round(
        100.0 * (out["spec_real_tokens_per_s"]
                 / out["spec_real_plain_tokens_per_s"] - 1), 1)
    out.update(card_info(dev))
    return out


def flash_numbers(device, bh: int, s: int, d: int, group: int,
                  iters: tuple = (100, 30)) -> dict:
    """The flash kernels on ``[1, bh, s, d]`` bf16 q, k, v (seed 2),
    causal, each op timed by :func:`time_op` over ``iters`` (forward,
    forward + backward): the forward at ``2·bh·s²·d`` flops (causal
    halves the 4·bh·s²·d of the products); the forward and the backward
    to q, k *and* v under a cotangent of ones, at 3× the forward's flops
    (the training convention; the backward kernels recompute the scores,
    so the card does more); the grouped forward with ``group`` q heads per
    kv head; and the backward the tune table chose for (s, d)."""
    from tpu_dra_torch.workloads.flash import (flash_attention,
                                               resolve_bwd_impl)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)

    def draw(heads: int):
        return torch.randn((1, heads, s, d), generator=gen,
                           device=device).to(torch.bfloat16)
    q, k, v = draw(bh), draw(bh), draw(bh)
    flops = 2 * bh * s * s * d

    def forward(kk, vv):
        def op(x):
            with torch.no_grad():
                return flash_attention(x, kk, vv, causal=True)
        return op

    def fwd_bwd(x):
        leaves = [t.detach().requires_grad_() for t in (x, k, v)]
        out = flash_attention(*leaves, causal=True)
        dq, dk, dv = torch.autograd.grad(out, leaves, torch.ones_like(out))
        return dq + dk + dv

    tflops = flops / time_op(forward(k, v), q, iters[0]) / 1e12
    tflops_fb = 3 * flops / time_op(fwd_bwd, q, iters[1]) / 1e12
    hkv = bh // group
    kg, vg = draw(hkv), draw(hkv)
    tflops_g = flops / time_op(forward(kg, vg), q, iters[0]) / 1e12
    return {"pallas_flash_tflops": round(tflops, 2),
            "pallas_flash_mfu_pct": mfu_pct(tflops),
            "pallas_flash_fwd_bwd_tflops_effective": round(tflops_fb, 2),
            "pallas_flash_fwd_bwd_mfu_pct": mfu_pct(tflops_fb),
            "pallas_flash_bwd_impl": resolve_bwd_impl(s, d),
            "pallas_flash_gqa4_tflops": round(tflops_g, 2),
            "pallas_flash_gqa4_mfu_pct": mfu_pct(tflops_g),
            "pallas_flash_gqa4_group": bh // hkv}


def section_flash() -> dict:
    """The flash kernels at the reference's shape (``bench.py:141``):
    BH 8, S 4096, D 128, and 4 q heads per kv head for the grouped
    forward."""
    dev = resolve_device()
    out = flash_numbers(dev, **FLASH_SHAPE)
    out.update(card_info(dev))
    return out


def train_seconds(step, params, tokens, *, windows: int = 3,
                  iters: int = 10) -> tuple:
    """``(seconds a step, last loss, params)`` of ``step(params, tokens)
    -> (params, loss)``: one warm-up step, then the best of ``windows``
    windows of ``iters`` steps, each window closed by reading the loss
    back to the host (the reference's protocol)."""
    params, loss = step(params, tokens)
    lossf = float(loss)
    secs = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            params, loss = step(params, tokens)
        lossf = float(loss)
        secs = min(secs, (time.perf_counter() - t0) / iters)
    return secs, lossf, params


def train_keys(prefix: str, secs: float, tokens_per_step: int,
               n_params: int, loss: float) -> dict:
    """An arm's ``{prefix}_tokens_per_s``, ``_tflops`` and ``_mfu_pct``
    (6·N flops a token: forward 2, backward 4) and ``_loss_finite``."""
    tflops = 6 * n_params * tokens_per_step / secs / 1e12
    return {f"{prefix}_tokens_per_s": round(tokens_per_step / secs, 1),
            f"{prefix}_tflops": round(tflops, 2),
            f"{prefix}_mfu_pct": mfu_pct(tflops),
            f"{prefix}_loss_finite": math.isfinite(loss)}


def train_numbers(cfg: ModelConfig, batch: int, mesh, *,
                  long_cfg: ModelConfig | None = None, long_batch: int = 2,
                  windows: int = 3, iters: int = 10,
                  long_iters: int = 4) -> dict:
    """``section_train``'s arms on ``mesh`` (a 1×1 ``{"dp", "tp"}``
    mesh), every step ``train.make_sharded_train_step`` with flash
    attention on zero tokens, weights from seed 0 on the mesh's device:

    - the headline step on ``[batch, max_seq]`` tokens (the trunk reads
      max_seq − 1 of them);
    - ``head_impl="chunked"`` from the headline's weights;
    - ``norm_impl="fused"`` on ``[batch, max_seq + 1]`` tokens, so that
      the trunk's ``batch·max_seq`` rows pass the RMSNorm-matmul's
      admission rule (at the reference's ``[batch, max_seq]`` it refuses
      every shape and the arm would time the plain pair); the arm fails
      unless the kernel ran, and its delta is in tokens/s;
    - with ``long_cfg``, its own model (a learned table of its max_seq
      rows) on ``[long_batch, long_cfg.max_seq]`` tokens, flash and the
      chunked head, ``long_iters`` steps a window.

    MFU counts the parameters' 6·N flops a token only."""
    from tpu_dra_torch.workloads import matmul as M
    from tpu_dra_torch.workloads.train import make_sharded_train_step
    dev = mesh.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    seq = cfg.max_seq
    tokens = torch.zeros((batch, seq), dtype=torch.int32, device=dev)
    tok_step = batch * (seq - 1)
    run = dict(windows=windows, iters=iters)
    step, _, _ = make_sharded_train_step(cfg, mesh, attn_impl="flash")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    secs, loss, params = train_seconds(step, params, tokens, **run)
    out = train_keys("train_step", secs, tok_step, n_params, loss)
    out["train_loss_finite"] = out.pop("train_step_loss_finite")
    out["train_params_m"] = round(n_params / 1e6, 2)
    if dev.type == "cuda":
        out["train_step_peak_gb"] = round(
            torch.cuda.max_memory_allocated(dev) / 1e9, 2)
    step, _, _ = make_sharded_train_step(cfg, mesh, attn_impl="flash",
                                         head_impl="chunked")
    secs_c, loss, params = train_seconds(step, params, tokens, **run)
    out.update(train_keys("train_step_chunked", secs_c, tok_step, n_params,
                          loss))
    step, _, _ = make_sharded_train_step(cfg, mesh, attn_impl="flash",
                                         norm_impl="fused")
    fused_tokens = torch.zeros((batch, seq + 1), dtype=torch.int32,
                               device=dev)
    before = M.fused_rmsnorm_matmul.launches
    secs_f, loss, params = train_seconds(step, params, fused_tokens, **run)
    launched = M.fused_rmsnorm_matmul.launches - before
    if dev.type == "cuda" and not launched:
        raise RuntimeError("the fused arm never launched the "
                           "RMSNorm-matmul kernel")
    fused = train_keys("train_step_fused", secs_f, batch * seq, n_params,
                       loss)
    out.update(fused)
    out["train_step_fused_norm_launches"] = launched
    out["train_step_fused_delta_pct"] = round(
        100.0 * (fused["train_step_fused_tokens_per_s"]
                 / out["train_step_tokens_per_s"] - 1.0), 1)
    del params, step
    if long_cfg is not None:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        gen.manual_seed(0)
        lparams = init_params(long_cfg, gen)
        n_long = sum(t.numel() for t in tree_leaves(lparams))
        lseq = long_cfg.max_seq
        ltokens = torch.zeros((long_batch, lseq), dtype=torch.int32,
                              device=dev)
        lstep, _, _ = make_sharded_train_step(long_cfg, mesh,
                                              attn_impl="flash",
                                              head_impl="chunked")
        secs_l, loss, lparams = train_seconds(
            lstep, lparams, ltokens, windows=windows, iters=long_iters)
        long = train_keys("train_long", secs_l, long_batch * (lseq - 1),
                          n_long, loss)
        del long["train_long_tflops"]
        out["train_long_seq"] = lseq
        out.update(long)
    return out


def section_train() -> dict:
    """The flagship's training step on one card (``bench.py:195``):
    vocab 32768, d_model 2048, 16 heads, 8 layers, d_ff 8192, max_seq
    1024, ~539 M parameters, batch 16 (see :func:`train_numbers`), and
    the long arm at S = 4096, batch 2."""
    from tpu_dra_torch.workloads.mesh import Mesh
    dev = resolve_device()
    cfg = ModelConfig(**TRAIN_MODEL)
    long_cfg = dataclasses.replace(cfg, max_seq=TRAIN_LONG["seq"])
    out = train_numbers(cfg, TRAIN_BATCH, Mesh({"dp": 1, "tp": 1},
                                                device=dev),
                        long_cfg=long_cfg, long_batch=TRAIN_LONG["batch"])
    out.update(card_info(dev))
    return out


def section_visibility() -> dict:
    """The visibility contract on the card (``bench.py:882``): a child
    process started with ``CUDA_VISIBLE_DEVICES`` naming this card (what
    the driver's claim environment does for a TPU's chips) must see
    exactly one device, on the ``"gpu"`` platform.  A child that fails
    raises."""
    dev = resolve_device()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(dev.index or 0))
    code = ("import json, torch; print(json.dumps({'n': "
            "torch.cuda.device_count(), 'platform': 'gpu' if "
            "torch.cuda.is_available() else 'cpu'}))")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=240)
    if proc.returncode:
        raise RuntimeError(f"visibility child exited {proc.returncode}: "
                           f"{proc.stderr[-300:]}")
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    out = {"visibility_ok": seen["n"] == 1 and seen["platform"] == "gpu",
           "visibility_seen_devices": seen["n"],
           "visibility_child_platform": seen["platform"]}
    out.update(card_info(dev))
    return out


# One tenant of section_multiprocess: the port's launcher installs the
# budget, a 1024² bf16 product of ones must sum to exactly 1024³, and
# with BENCH_MP_OVERALLOC one allocation of 1.5x the budget must be
# refused by the allocator.  It prints one JSON line.
MP_CHILD = """
import json, os
import torch
from tpu_dra_torch.workloads.launcher import apply_hbm_limits
lim = apply_hbm_limits()
x = torch.ones((1024, 1024), dtype=torch.bfloat16, device="cuda")
s = float((x @ x).float().sum())
total = torch.cuda.get_device_properties(0).total_memory
cap = int(torch.cuda.get_per_process_memory_fraction(0) * total)
over = None
if os.environ.get("BENCH_MP_OVERALLOC") and lim:
    try:
        big = torch.empty(int(lim * 1.5) // 4, dtype=torch.float32,
                          device="cuda")
        torch.cuda.synchronize()
        over = "allowed"
        del big
    except torch.cuda.OutOfMemoryError:
        over = "rejected"
print(json.dumps({"ok": s == 1024.0 ** 3, "limit": lim, "overalloc": over,
                  "bytes_limit": cap}))
"""


def multiprocess_summary(results: list) -> dict:
    """The section's keys from its children's JSON lines (``{"error":
    ...}`` for a child that printed none): both succeeded is
    ``"shared"``, one ``"exclusive"``, none ``"failed"``; the cap the
    first good child's allocator holds and whether it stays within its
    budget; whether the over-budget allocation was refused."""
    ok = [r for r in results if r.get("ok")]
    out = {"multiprocess_ok": len(ok) == 2,
           "multiprocess_succeeded": len(ok),
           "multiprocess_mode": ("shared" if len(ok) == 2 else
                                 "exclusive" if len(ok) == 1 else "failed")}
    if ok and ok[0].get("bytes_limit") is not None:
        out["multiprocess_bytes_limit"] = ok[0]["bytes_limit"]
        out["multiprocess_limit_respected"] = (
            ok[0]["limit"] is not None
            and ok[0]["bytes_limit"] <= ok[0]["limit"])
    over = [r["overalloc"] for r in results if r.get("overalloc")]
    if over:
        out["multiprocess_cap_enforced"] = over[0] == "rejected"
    if not ok:
        out["multiprocess_error"] = str(results)[:300]
    return out


def section_multiprocess() -> dict:
    """Two processes on one card at once (``bench.py:914``), each with
    the environment the driver gives a tenant: the card through
    ``CUDA_VISIBLE_DEVICES`` and ``TPU_VISIBLE_CHIPS=0``, and
    ``TPU_HBM_LIMIT_BYTES_0`` at half the card's memory, which
    ``launcher.apply_hbm_limits`` installs as the caching allocator's cap
    (:data:`MP_CHILD`; the children import ``tpu_dra_torch`` only).  One
    child also tries an allocation of 1.5x its budget.  CUDA lets any
    number of processes open a card, so the reference's
    ``TPU_ALLOW_MULTIPLE_LIBTPU_LOAD`` has no counterpart here.  Returns
    :func:`multiprocess_summary` and the budget."""
    dev = resolve_device()
    limit = torch.cuda.get_device_properties(dev).total_memory // 2
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(dev.index or 0),
               TPU_VISIBLE_CHIPS="0", TPU_HBM_LIMIT_BYTES_0=str(limit),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    procs = [subprocess.Popen([sys.executable, "-c", MP_CHILD], env=e,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(ROOT))
             for e in (dict(env, BENCH_MP_OVERALLOC="1"), env)]
    results = []
    deadline = time.monotonic() + 220
    for p in procs:
        try:
            stdout, stderr = p.communicate(
                timeout=max(deadline - time.monotonic(), 5))
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            results.append({"error": "timeout"})
            continue
        try:
            results.append(json.loads(stdout.strip().splitlines()[-1]))
        except (IndexError, ValueError):
            results.append({"error": (stderr or stdout)[-200:]})
    out = multiprocess_summary(results)
    out["multiprocess_budget_bytes"] = limit
    out.update(card_info(dev))
    return out


# (m, K, N) a rank of the fused collective-matmul comparison
# (reference bench.py 1055-1110): on the card, and on the CPU
COLLECTIVE_MATMUL_SHAPE = {"cuda": (1024, 2048, 2048), "cpu": (64, 128, 128)}
COLLECTIVE_MATMUL_ITERS = {"cuda": 5, "cpu": 2}


def _synced_seconds(fn, dev, iters: int, group) -> float:
    """Seconds of one ``fn()`` by the host clock: warmed once, then the
    group met and ``iters`` calls timed to a synchronized stream, median
    of three runs.  The process ring synchronizes and meets its group
    at every step, which a CUDA graph cannot capture."""
    import torch.distributed as dist

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fn()
    runs = []
    for _ in range(3):
        sync()
        dist.barrier(group=group)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        runs.append((time.perf_counter() - t0) / iters)
    return sorted(runs)[1]


def collective_matmul_numbers(dev, group=None) -> dict:
    """The fused ring kernels across this group's processes
    (``collective_matmul.ProcessRing``) against the unfused pair on the
    same shapes: the all-gather-matmul against a group all-gather then a
    matmul, the matmul-reduce-scatter against a matmul then a group
    reduce-scatter (each rank's ``[n·m, K]`` operand its ``[m, K]`` shard
    tiled, as the reference tiles it).  ``*_fused_tflops`` and
    ``*_xla_tflops`` count ``2·n·m·K·N`` a rank, as the reference does;
    ``*_overlap_win_pct`` is the unfused time over the fused one, less 1.
    Under gloo the unfused collectives stage through host memory."""
    from tpu_dra_torch.workloads.collective_matmul import ProcessRing
    from tpu_dra_torch.workloads.mesh import (group_all_gather,
                                              group_reduce_scatter)
    from tpu_dra_torch.workloads.train import dot_f32
    ring = ProcessRing(group)
    n = ring.n
    m, K, N = COLLECTIVE_MATMUL_SHAPE[dev.type]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1 + ring.rank)
    w = torch.randn((K, N), generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((m, K), generator=gen, device=dev).to(torch.bfloat16)
    xs = x.repeat(n, 1)
    pairs = {
        "ag_matmul": (
            lambda: ring.all_gather_matmul(x, w)[0],
            lambda: dot_f32(torch.cat(group_all_gather(x, group)),
                            w).to(x.dtype)),
        "matmul_rs": (
            lambda: ring.matmul_reduce_scatter(xs, w),
            lambda: group_reduce_scatter(dot_f32(xs, w), group).to(x.dtype)),
    }
    flops = 2 * n * m * K * N
    iters = COLLECTIVE_MATMUL_ITERS[dev.type]
    out = {}
    try:
        for name, (fused, unfused) in pairs.items():
            secs_f = _synced_seconds(fused, dev, iters, group)
            secs_u = _synced_seconds(unfused, dev, iters, group)
            out[f"{name}_fused_tflops"] = round(flops / secs_f / 1e12, 4)
            out[f"{name}_xla_tflops"] = round(flops / secs_u / 1e12, 4)
            out[f"{name}_overlap_win_pct"] = round(
                100.0 * (secs_u / secs_f - 1.0), 1)
    finally:
        ring.close()
    out["collective_matmul_shape"] = [m, K, N]
    out["collective_matmul_device"] = str(dev)
    return out


def section_collectives() -> dict:
    """The four collective bandwidths over this process's
    ``torch.distributed`` group (``workloads/collectives.py``): the
    reference runs the section only with more than one device and
    answers ``{"collectives_skipped": "single device"}`` on one, as this
    does in a group of one or without a group.  Over a larger group:
    ``psum_gbps``, ``ppermute_gbps``, ``all_gather_gbps`` and
    ``reduce_scatter_gbps``, with the backend and the buffers' device
    (under gloo the host's memory: no card-to-card figure), then the
    fused collective-matmul comparison on the card
    (:func:`collective_matmul_numbers`); a failure there is kept as
    ``collective_matmul_error``, as the reference keeps it, so the
    bandwidths survive it."""
    import torch.distributed as dist

    from tpu_dra_torch.workloads.collectives import (
        all_gather_bandwidth, group_device, ppermute_bandwidth,
        psum_bandwidth, reduce_scatter_bandwidth)
    card = resolve_device()          # a section measures the card
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() <= 1:
        return {"collectives_skipped": "single device"}
    suite = {"psum": psum_bandwidth, "ppermute": ppermute_bandwidth,
             "all_gather": all_gather_bandwidth,
             "reduce_scatter": reduce_scatter_bandwidth}
    out = {f"{name}_gbps": round(bench().algo_bytes_per_s / 1e9, 2)
           for name, bench in suite.items()}
    dev = group_device()
    out["collectives_backend"] = dist.get_backend()
    out["collectives_devices"] = dist.get_world_size()
    out["collectives_buffer_device"] = str(dev)
    try:
        out.update(collective_matmul_numbers(card))
    except Exception as exc:  # noqa: BLE001 — keep the bandwidth numbers
        out["collective_matmul_error"] = repr(exc)[:200]
    if card.type == "cuda":
        out.update(card_info(card))
    return out


SECTIONS = {"probe": section_probe, "matmul": section_matmul,
            "pallas_matmul": section_pallas_matmul, "flash": section_flash,
            "train": section_train,
            "decode": section_decode, "decode_long": section_decode_long,
            "continuous": section_continuous, "paged": section_paged,
            "spec_real": section_spec_real,
            "visibility": section_visibility,
            "multiprocess": section_multiprocess,
            "collectives": section_collectives}


def main(argv=None) -> None:
    names = (sys.argv[1:] if argv is None else argv) or list(SECTIONS)
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        raise SystemExit(f"unknown sections {unknown}; choose from "
                         f"{sorted(SECTIONS)}")
    out: dict = {}
    for name in names:
        out.update(SECTIONS[name]())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
